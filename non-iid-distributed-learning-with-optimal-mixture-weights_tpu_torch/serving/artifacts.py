"""Exported serving artifacts: the cold-start plane, in this package's
own currency.

The port of the JAX package's ``serving/artifacts.py``: the same names,
the same typed compatibility contract, the same retention rule, over a
format of its own. The JAX artifact holds each rung twice, as a
``jax.export`` program and as a serialized XLA executable; neither
exists here. This package's artifact holds each rung ONCE:

- ``rung_<b>.pt2`` — the **portable program**: ``torch.export.export``
  of the engine's rung forward (``ServingEngine._forward``: ``rff_map``
  when the checkpoint carries its draw, the ``feature_dtype`` cast, the
  model's ``apply``) at the rung's static shape, saved with
  ``torch.export.save``. Its inputs are the padded batch, every weight
  leaf (in sorted key order) and, when the map is fused, the RFF draw
  ``W``, ``b`` and ``sqrt(D)``; the program holds no tensor of its own
  (export refuses one that would) and is saved without the inputs it was
  traced on, so it pins no device, nothing is mapped at load, and no
  weight is in the file: the weights stay call arguments, exactly as
  the JAX artifact keeps them, and ``swap_weights``/versioned
  ``predict`` work unchanged on an artifact-loaded engine.
- **No native executable.** Eager PyTorch has none to serialize, and an
  ahead-of-time compiler (AOT Inductor) would be a path the JAX engine
  does not take. The manifest says so in a field of its own,
  ``native_executable``, always null; a manifest naming one is refused.

:class:`ArtifactManifest` is the fingerprint that decides where the
programs may run, the JAX fields in this package's currency: torch and
CUDA runtime versions, platform (``cuda``/``cpu``), device kind
(``torch.cuda.get_device_name``) and compute capability, machine and,
on the CPU, its feature flags; ``n_devices``, input and feature dtype,
the model's zoo name, the bucket set, every weight leaf's shape and
dtype, the RFF draw's, the source version and round, the schema, and
each rung file's size and sha256.

:func:`load_ladder` validates the manifest against the RUNNING host
(the device the engine will serve from), then loads every rung program,
checks its bytes against the manifest's sha256 and its input and output
signature against the manifest's fields, and raises a typed
:class:`ArtifactIncompatible` naming every mismatched field. A program
that does not load is refused the same way — never a fallback to
tracing the model again. Each loaded rung runs once at load
(``ServingEngine.from_artifact``), off the serving path, and
``compile_count`` (the shapes the eager forward dispatched) stays 0.

``ServingEngine.from_artifact`` wires this in; ``CheckpointWatcher(
artifact_dir=...)`` exports beside every published checkpoint;
``chip_smoke.py``'s ``fleet`` phase drives it on the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..fedcore.aggregate import full_fp32
from ..ops.rff import rff_scale

#: Serializes export_ladder bodies: ``torch.export`` traces under
#: process-global tracing state, and a concurrent export (the watcher's
#: thread against an operator call) must not interleave with it.
_EXPORT_LOCK = threading.Lock()

#: Manifest schema tag. Bump on any field-semantics change: load_ladder
#: refuses unknown majors, so an old serving box can never misread a
#: newer manifest as compatible. Not the JAX package's tag: the two
#: formats hold different programs.
ARTIFACT_SCHEMA = "SERVE_ARTIFACT_TORCH.v1"
MANIFEST_NAME = "manifest.json"

#: The program currency a rung file holds.
PROGRAM_FORMAT = "torch.export"

#: The padded request-batch dtype the engine dispatches
#: (``ServingEngine._run`` pads float32).
_INPUT_DTYPE = "float32"


class ArtifactIncompatible(RuntimeError):
    """The artifact cannot run on this host (or under these weights).

    Raised by :func:`load_ladder` / :func:`validate_weights` with the
    FULL list of mismatched fields — each as ``(field, artifact_value,
    host_value)`` — so one failed start names every incompatibility at
    once instead of one per restart."""

    def __init__(self, artifact_dir: str, mismatches):
        self.artifact_dir = str(artifact_dir)
        self.mismatches = list(mismatches)
        detail = "; ".join(
            f"{field}: artifact={a!r} vs host={h!r}"
            for field, a, h in self.mismatches)
        super().__init__(
            f"serving artifact {self.artifact_dir!r} is incompatible "
            f"with this host: {detail} — re-export on (or for) this "
            "host class with serving.artifacts.export_ladder")


def _cpu_feature_fingerprint() -> str | None:
    """Stable digest of the host CPU's feature flags (Linux: the
    ``flags`` line of /proc/cpuinfo): on the CPU the same program may
    pick another kernel, and answer in other bits, on a CPU with other
    features. None when unreadable (the check is then skipped)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = sorted(line.split(":", 1)[1].split())
                    blob = " ".join(flags).encode()
                    return hashlib.sha256(blob).hexdigest()[:16]
    except OSError:
        pass
    return None


def host_fingerprint(device=None) -> dict:
    """The running host's side of the compatibility contract, for the
    device an engine serves from (the card when None; raises without
    one, like every entry point). Pure reads."""
    import platform as _platform

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        major, minor = torch.cuda.get_device_capability(dev)
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev) if cuda
                        else "cpu"),
        "compute_capability": f"{major}.{minor}" if cuda else None,
        "machine": _platform.machine(),
        "cpu_features": None if cuda else _cpu_feature_fingerprint(),
    }


#: The host fields that must match exactly.
_HOST_FIELDS = ("torch_version", "cuda_version", "platform",
                "device_kind", "compute_capability", "machine")


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _leaf_sig(x) -> list:
    """``[shape, dtype]`` of one weight leaf (a tensor or an array),
    JSON-shaped, dtypes by their numpy-style name."""
    if isinstance(x, torch.Tensor):
        return [list(x.shape), _dtype_name(x.dtype)]
    arr = np.asarray(x)
    return [list(arr.shape), str(arr.dtype)]


@dataclasses.dataclass(frozen=True)
class ArtifactManifest:
    """The artifact's identity: what it computes, and where it may run.

    The HOST half (``host``, ``n_devices``, ``program_format``,
    ``native_executable``, ``dtype``) gates :func:`load_ladder`; the
    PROGRAM half (buckets, dtypes, weight signature, rff) gates
    :func:`validate_weights` and each rung program's signature — so
    "wrong machine" and "wrong weights" are distinct, fully-named
    failures."""

    schema: str
    host: dict            # host_fingerprint() of the exporting machine
    n_devices: int
    program_format: str   # PROGRAM_FORMAT
    native_executable: str | None  # always None: eager PyTorch has none
    dtype: str            # padded request-batch dtype
    feature_dtype: str | None
    model: str | None     # the zoo name of the exported model
    buckets: list
    input_dim: int
    num_classes: int
    param_sig: dict       # weight key -> [shape, dtype]
    rff_sig: dict | None  # {"W": [shape, dtype], "b": [...]} or None
    model_version: int | None
    round_idx: int | None
    created_at: float
    rungs: dict           # str(bucket) -> {program, bytes, sha256}

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "ArtifactManifest":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in fields})

    def save(self, artifact_dir: str) -> str:
        path = os.path.join(artifact_dir, MANIFEST_NAME)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, artifact_dir: str) -> "ArtifactManifest":
        path = os.path.join(artifact_dir, MANIFEST_NAME)
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ArtifactIncompatible(
                artifact_dir, [("manifest", f"unreadable ({e})",
                                "readable manifest.json required")])
        if not isinstance(obj, dict) or "schema" not in obj:
            raise ArtifactIncompatible(
                artifact_dir, [("manifest", obj if not isinstance(
                    obj, dict) else sorted(obj), "manifest object "
                    "with a 'schema' field")])
        if obj["schema"] != ARTIFACT_SCHEMA:
            # the major refusal, enforced BEFORE field parsing: another
            # schema may rename or re-type fields
            raise ArtifactIncompatible(
                artifact_dir,
                [("schema", obj["schema"], ARTIFACT_SCHEMA)])
        try:
            return cls.from_json(obj)
        except TypeError as e:
            raise ArtifactIncompatible(
                artifact_dir, [("manifest", f"malformed ({e})",
                                f"complete {ARTIFACT_SCHEMA} field "
                                "set")]) from None


class _RungForward(torch.nn.Module):
    """The engine's rung forward over flat tensor inputs — what
    ``torch.export`` traces: ``(x, *weight_leaves[, W, b, scale])``."""

    def __init__(self, engine, keys: tuple, fused: bool):
        super().__init__()
        self._engine = engine
        self._keys = keys
        self._fused = fused

    def forward(self, x, *leaves):
        n = len(self._keys)
        params = dict(zip(self._keys, leaves[:n]))
        rff = tuple(leaves[n:]) if self._fused else None
        return self._engine._forward(x, params, rff)


class RungProgram:
    """One loaded rung program, callable as ``fn(x, params, rff)`` with
    the engine's forward signature: ``x`` the padded ``(bucket, d)``
    float32 batch on the serving device, ``params`` the weight dict and
    ``rff`` ``(W, b[, scale])`` or None."""

    def __init__(self, bucket: int, program, keys: tuple, fused: bool):
        self.bucket = int(bucket)
        self.program = program          # the torch.export.ExportedProgram
        self._module = program.module()
        self.keys = tuple(keys)
        self.fused = bool(fused)

    def __call__(self, x, params, rff):
        leaves = [params[k] for k in self.keys]
        if self.fused:
            W, b = rff[0], rff[1]
            scale = rff[2] if len(rff) > 2 else rff_scale(W.shape[1],
                                                         W.device)
            leaves += [W, b, scale]
        return self._module(x, *leaves)


def _flat_leaves(params: dict, rff) -> tuple:
    keys = tuple(sorted(params))
    leaves = [params[k] for k in keys]
    if rff is not None:
        leaves += [rff[0], rff[1], rff[2]]
    return keys, leaves


def _drop_example_inputs(program) -> None:
    """Forget the inputs ``program`` was traced on (``torch.export``
    keeps them and ``torch.export.save`` writes them)."""
    try:
        program.example_inputs = None
    except AttributeError:
        program._example_inputs = None


def export_ladder(engine, out_dir: str, model_version: int | None = None,
                  round_idx: int | None = None) -> ArtifactManifest:
    """Export every rung of ``engine``'s bucket ladder into ``out_dir``
    (created if missing) and return the written manifest.

    Per rung: one ``torch.export`` program of the engine's forward at
    the rung's shape, traced on the engine's device. SELF-CHECK before
    the file lands: the serialized bytes load back and answer seeded
    rows bitwise as the engine's own forward does — an artifact that
    disagrees with its engine is refused here, at export, not at every
    replica start. The engine's serving state is untouched (nothing is
    dispatched through its ladder, ``compile_count`` does not move).

    ``model_version``/``round_idx`` stamp provenance; weights stay OUT
    of the artifact, and any swap-compatible version serves through
    it."""
    if engine.mesh is not None:
        raise ValueError(
            "export_ladder supports single-device engines only: an "
            "exported executable bakes in its device assignment, and "
            "a mesh-replicated ladder must be re-exported per mesh "
            "shape (load the checkpoint without mesh= to export)")
    os.makedirs(out_dir, exist_ok=True)
    params, rff, _ = engine._resolve(None)
    p0, r0 = params[0], (None if rff is None else rff[0])
    keys, leaves = _flat_leaves(p0, r0)
    module = _RungForward(engine, keys, r0 is not None)
    dev = engine.device
    rungs: dict = {}
    with _EXPORT_LOCK:
        for b in engine.buckets:
            b = int(b)
            x0 = torch.zeros((b, engine.input_dim), dtype=torch.float32,
                             device=dev)
            with torch.no_grad():
                program = torch.export.export(module, (x0, *leaves),
                                              strict=False)
            held = list(program.state_dict) + list(
                getattr(program, "constants", {}) or {})
            if held:
                raise RuntimeError(
                    f"rung {b}'s program holds tensors {held}: the "
                    "weights must be call arguments, and a held tensor "
                    "would pin the exporting device")
            # an exported program keeps the inputs it was traced on, and
            # saves them: here the exporting version's weights, which
            # stay out of the artifact
            _drop_example_inputs(program)
            buf = io.BytesIO()
            torch.export.save(program, buf)
            blob = buf.getvalue()
            x = torch.from_numpy(np.random.RandomState(b).randn(
                b, engine.input_dim).astype(np.float32)).to(dev)
            try:
                loaded = torch.export.load(io.BytesIO(blob))
                if getattr(loaded, "example_inputs", None) is not None:
                    raise RuntimeError("the saved program holds its "
                                       "example inputs (the weights)")
                back = loaded.module()
                with torch.inference_mode(), full_fp32():
                    got = back(x, *leaves)
                    want = engine._forward(x, p0, r0)
            except Exception as e:
                raise RuntimeError(
                    f"export self-check failed for rung {b}: the "
                    "just-serialized program does not load back "
                    f"({type(e).__name__}: {e})") from e
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"export self-check failed for rung {b}: "
                    "round-tripped program disagrees with the engine's "
                    "forward — refusing to write a lying artifact")
            name = f"rung_{b}.pt2"
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(blob)
            rungs[str(b)] = {"program": name, "bytes": len(blob),
                             "sha256": hashlib.sha256(blob).hexdigest()}
    fdtype = engine._fdtype
    manifest = ArtifactManifest(
        schema=ARTIFACT_SCHEMA,
        host=host_fingerprint(dev),
        n_devices=1,
        program_format=PROGRAM_FORMAT,
        native_executable=None,
        dtype=_INPUT_DTYPE,
        feature_dtype=None if fdtype is None else _dtype_name(fdtype),
        model=getattr(engine.model, "name", None),
        buckets=[int(b) for b in engine.buckets],
        input_dim=int(engine.input_dim),
        num_classes=int(engine.num_classes),
        param_sig={str(k): _leaf_sig(v) for k, v in p0.items()},
        rff_sig=(None if r0 is None
                 else {"W": _leaf_sig(r0[0]), "b": _leaf_sig(r0[1])}),
        model_version=(None if model_version is None
                       else int(model_version)),
        round_idx=None if round_idx is None else int(round_idx),
        created_at=time.time(),
        rungs=rungs,
    )
    manifest.save(out_dir)
    return manifest


def validate_manifest(manifest: ArtifactManifest,
                      artifact_dir: str = "<artifact>",
                      device=None) -> None:
    """Raise :class:`ArtifactIncompatible` unless the manifest's host
    half matches the RUNNING host (for ``device``, the card when None)
    exactly. Every mismatched field is collected before raising — one
    refusal names them all."""
    mismatches = []
    if str(manifest.schema) != ARTIFACT_SCHEMA:
        mismatches.append(("schema", manifest.schema, ARTIFACT_SCHEMA))
    host = host_fingerprint(device)
    art_host = dict(manifest.host or {})
    for field in _HOST_FIELDS:
        if art_host.get(field) != host[field]:
            mismatches.append((field, art_host.get(field), host[field]))
    # CPU features: checked only when BOTH sides fingerprinted
    a_feat, h_feat = art_host.get("cpu_features"), host["cpu_features"]
    if a_feat is not None and h_feat is not None and a_feat != h_feat:
        mismatches.append(("cpu_features", a_feat, h_feat))
    if manifest.n_devices != 1:
        mismatches.append(("n_devices", manifest.n_devices, 1))
    if manifest.program_format != PROGRAM_FORMAT:
        mismatches.append(("program_format", manifest.program_format,
                           PROGRAM_FORMAT))
    if manifest.native_executable is not None:
        mismatches.append(("native_executable",
                           manifest.native_executable, None))
    if str(manifest.dtype) != _INPUT_DTYPE:
        mismatches.append(("dtype", manifest.dtype, _INPUT_DTYPE))
    if mismatches:
        raise ArtifactIncompatible(artifact_dir, mismatches)


def validate_weights(manifest: ArtifactManifest, params, rff,
                     artifact_dir: str = "<artifact>") -> None:
    """Raise :class:`ArtifactIncompatible` unless ``params``/``rff``
    match the signature the ladder was exported against — same weight
    keys, same leaf shapes and dtypes, same rff-ness. The programs take
    weights as call arguments, so ANY matching version serves through
    them; a mismatch would be a signature error inside the loaded
    program, surfaced here as the typed contract instead."""
    mismatches = []
    sig = {str(k): _leaf_sig(v) for k, v in params.items()}
    want = {str(k): [list(s), str(d)]
            for k, (s, d) in manifest.param_sig.items()}
    if sig != want:
        only_art = sorted(set(want) - set(sig))
        only_here = sorted(set(sig) - set(want))
        if only_art or only_here:
            mismatches.append(("param_keys", sorted(want), sorted(sig)))
        for k in sorted(set(want) & set(sig)):
            if want[k] != sig[k]:
                mismatches.append((f"param[{k}]", want[k], sig[k]))
    art_rff = manifest.rff_sig
    if (rff is None) != (art_rff is None):
        mismatches.append(("rff_fused", art_rff is not None,
                           rff is not None))
    elif rff is not None:
        got = {"W": _leaf_sig(rff[0]), "b": _leaf_sig(rff[1])}
        want_r = {k: [list(s), str(d)]
                  for k, (s, d) in art_rff.items()}
        if got != want_r:
            mismatches.append(("rff_sig", want_r, got))
    if mismatches:
        raise ArtifactIncompatible(artifact_dir, mismatches)


def _program_signature(program) -> tuple:
    """``([(shape, dtype)] of the user inputs, [(shape, dtype)] of the
    outputs)`` of an exported program, read off its graph."""
    user = list(program.graph_signature.user_inputs)
    ins, outs = {}, []
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name in user:
            val = node.meta.get("val")
            ins[node.name] = (None if val is None else
                              (list(val.shape), _dtype_name(val.dtype)))
        elif node.op == "output":
            for arg in node.args[0]:
                val = getattr(arg, "meta", {}).get("val")
                outs.append(None if val is None else
                            (list(val.shape), _dtype_name(val.dtype)))
    return [ins.get(n) for n in user], outs


def _expected_signature(manifest: ArtifactManifest, bucket: int) -> tuple:
    """The signature the manifest says rung ``bucket``'s program has."""
    ins = [([int(bucket), int(manifest.input_dim)], _INPUT_DTYPE)]
    for k in sorted(manifest.param_sig):
        shape, dtype = manifest.param_sig[k]
        ins.append((list(shape), str(dtype)))
    if manifest.rff_sig is not None:
        for k in ("W", "b"):
            shape, dtype = manifest.rff_sig[k]
            ins.append((list(shape), str(dtype)))
        ins.append(([], "float32"))
    outs = [([int(bucket), int(manifest.num_classes)], "float32")]
    return ins, outs


def _read_rung(artifact_dir: str, manifest: ArtifactManifest,
               key: str):
    """One rung's program: bytes checked against the manifest's sha256,
    then deserialized. Raises on any failure (the caller types it)."""
    rec = manifest.rungs[key]
    with open(os.path.join(artifact_dir, rec["program"]), "rb") as f:
        blob = f.read()
    digest = hashlib.sha256(blob).hexdigest()
    if digest != rec.get("sha256"):
        raise ValueError(f"sha256 {digest[:16]}.. is not the manifest's "
                         f"{str(rec.get('sha256'))[:16]}..")
    return torch.export.load(io.BytesIO(blob))


def load_ladder(artifact_dir: str, device=None) -> tuple[
        ArtifactManifest, dict]:
    """Validate + load an artifact directory: returns ``(manifest,
    {bucket: RungProgram})``, each callable as ``fn(x, params, rff)``
    with the engine's forward signature. ``device``: where the programs
    will run (the card when None) — the host half is checked for it.
    Any host mismatch raises :class:`ArtifactIncompatible` BEFORE any
    program is read; a rung file that is missing, altered, fails to
    load, or whose input or output signature is not the manifest's, is
    reported the same typed way (a half-loadable artifact must not
    half-serve)."""
    manifest = ArtifactManifest.load(artifact_dir)
    validate_manifest(manifest, artifact_dir, device)
    keys = tuple(sorted(manifest.param_sig))
    fused = manifest.rff_sig is not None
    rungs: dict = {}
    problems = []
    for key in manifest.rungs:
        try:
            program = _read_rung(artifact_dir, manifest, key)
            got = _program_signature(program)
            want = _expected_signature(manifest, int(key))
            if got != (list(want[0]), list(want[1])):
                problems.append((f"rung[{key}]", f"program signature "
                                 f"{got}", f"the manifest's {want}"))
                continue
            rungs[int(key)] = RungProgram(int(key), program, keys, fused)
        except Exception as e:
            problems.append((f"rung[{key}]",
                             f"{type(e).__name__}: {e}",
                             f"loadable {PROGRAM_FORMAT} program"))
    if problems:
        raise ArtifactIncompatible(artifact_dir, problems)
    want_b = {int(b) for b in manifest.buckets}
    if set(rungs) != want_b:
        raise ArtifactIncompatible(
            artifact_dir, [("rungs", sorted(rungs), sorted(want_b))])
    return manifest, rungs


#: Exported-artifact directory names a watcher writes: the same
#: ``vNNNN`` family the registry ingests (``registry._VERSION_DIR``) —
#: one exported ladder per published round boundary.
_ARTIFACT_DIR = re.compile(r"^v(\d+)$")


def prune_artifacts(artifact_dir: str, keep: int,
                    protect=()) -> list[str]:
    """Drop the oldest exported ``vNNNN`` artifact directories under
    ``artifact_dir`` down to ``keep``, never touching a protected
    entry — the artifact-side twin of ``ModelRegistry.prune`` (same
    contract: ``keep`` bounds the TOTAL count, protected entries are
    excluded from deletion even when that leaves more than ``keep``).

    ``protect``: version numbers (ints) and/or directory names
    (``"v0004"``) that must survive — the caller pins the live and
    candidate versions here, because deleting the artifact a replica
    is about to cold-start from turns a scale-out into an eager
    warm-up. Returns the directory names removed (oldest first). A
    missing ``artifact_dir`` is a normal startup state (nothing was
    exported yet), not an error."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    if isinstance(protect, (str, int)):
        # a bare "v0004" would otherwise iterate per CHARACTER and
        # silently protect nothing
        protect = (protect,)
    protected_nums: set[int] = set()
    protected_names: set[str] = set()
    for p in protect:
        if isinstance(p, int):
            protected_nums.add(p)
        else:
            name = str(p)
            protected_names.add(name)
            m = _ARTIFACT_DIR.match(name)
            if m:
                protected_nums.add(int(m.group(1)))
    try:
        names = os.listdir(artifact_dir)
    except OSError:
        return []
    entries = []
    for name in names:
        m = _ARTIFACT_DIR.match(name)
        if m and os.path.isdir(os.path.join(artifact_dir, name)):
            entries.append((int(m.group(1)), name))
    entries.sort()
    candidates = [(n, name) for n, name in entries
                  if n not in protected_nums
                  and name not in protected_names]
    removed = []
    excess = len(entries) - int(keep)
    for _, name in candidates[:max(0, excess)]:
        shutil.rmtree(os.path.join(artifact_dir, name))
        removed.append(name)
    return removed


def load_portable(artifact_dir: str, bucket: int):
    """One rung's portable program, the ``torch.export.ExportedProgram``
    (its bytes checked against the manifest) — what an operator
    re-materializes from on a new host class before re-exporting. No
    host check: the program itself is device-free."""
    manifest = ArtifactManifest.load(artifact_dir)
    key = str(int(bucket))
    if key not in manifest.rungs:
        raise ArtifactIncompatible(
            artifact_dir, [("rungs", sorted(manifest.rungs),
                            f"rung {bucket} present")])
    try:
        return _read_rung(artifact_dir, manifest, key)
    except Exception as e:
        raise ArtifactIncompatible(
            artifact_dir, [(f"rung[{key}]", f"{type(e).__name__}: {e}",
                            f"loadable {PROGRAM_FORMAT} program")]) from e
