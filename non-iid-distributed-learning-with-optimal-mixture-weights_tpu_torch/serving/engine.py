"""Checkpoint -> predictor on the card: the serving half of the port.

The port of the JAX package's ``serving/engine.py``, with its names and
signatures. :class:`ServingEngine` restores a checkpoint (the pickle
layout of ``utils/checkpoint.py``), puts the weights on the device ONCE
(on every device of a serving mesh when one is given), and serves
queries through one predictor: the RFF map (``ops.rff.rff_map``, the
expression training used) when the checkpoint carries its draw, the cast
to ``feature_dtype`` when the run stored its features narrow, then
``model.apply``. It runs under ``fedcore.aggregate.full_fp32``, so
cuDNN's default TF32 never touches a conv model and the products are the
evaluator's. The serve path has no hand-written kernel: the JAX package
computes it with ``jax.jit`` of the same ``rff_map`` and ``apply``,
outside any Pallas kernel, and here it is ``torch.matmul`` and
``torch.cos``.

Shape discipline: every request batch is padded up to a fixed rung
ladder (default ``1/8/64/512/4096`` rows). PyTorch runs eagerly, so
nothing compiles; the ladder stays because it fixes the shapes — one rung
is one shape, one choice of product algorithm a shape — and a warmed
engine has dispatched every shape it will ever dispatch.
``compile_count`` is the JAX package's own fallback basis for its
counter (``engine.py:446-453``): the number of distinct padded shapes
dispatched, stable at ``len(self.buckets)`` after :meth:`warmup`. Rows
are independent through the whole network, so padding rows never change
a valid row's logits.

Serving mesh (``parallel.make_serving_mesh``): the weights live on every
device of the mesh, a rung is rounded UP to a multiple of the mesh size,
its rows are split into equal slices, one a device, and the logits are
concatenated on the host.

**Hot weight swap** (``serving/registry.py``, ``serving/rollout.py``):
weights are arguments of the forward, not part of it, so a new version
with the same structure, shapes and dtypes serves through the same
ladder — ``swap_weights`` installs it and flips the live pointer. The
engine can hold several versions at once (a rollout candidate);
``predict(version=...)`` dispatches a specific one, and ``version=None``
resolves the live version atomically AT DISPATCH TIME, under the one
lock that guards the pointer and the weights, so a retried request
re-resolves and never runs against a half-swapped engine. Old weights
free by refcount once the last in-flight dispatch holding them returns.

Not carried yet: ``from_artifact`` and ``install_rung(aot=...)`` wait for
this package's artifact format (ROADMAP.md queue 1 item 11 step 2), and
raise ``NotImplementedError``. The JAX engine donates its padded input
on a TPU; a torch tensor has nothing to donate, and each dispatch copies
its padded batch to the card once.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..fedcore.aggregate import full_fp32
from ..models import Model, linear_model, mlp_model
from ..ops.rff import rff_map, rff_scale

#: Default padded-batch ladder. Powers of 8: the step between rungs
#: bounds padding waste at 8x worst-case while keeping the number of
#: distinct shapes at 5 for the whole 1..4096-row request range.
DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)

_NOT_PORTED = ("waits for this package's artifact format: ROADMAP.md "
               "queue 1 item 11 step 2")


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest ladder rung holding ``n`` rows.

    Oversized requests are the CALLER's job to chunk (``predict`` does);
    returning the max bucket here would silently truncate.
    """
    if n <= 0:
        raise ValueError(f"need at least one row, got {n}")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"{n} rows exceeds the largest bucket {buckets[-1]}; "
        "chunk the request (ServingEngine.predict does this)")


def infer_model(params) -> Model:
    """Reconstruct the zoo member a checkpointed parameter dict belongs
    to: ``{"w"}`` is the linear model and ``{"w1","b1",...,"wK"}`` an MLP
    whose hidden widths are the leading dims of the hidden weights. Conv
    parameters do not pin down the raw input width — pass the Model
    explicitly for those (and ``input_dim=``)."""
    keys = set(params)
    if keys == {"w"}:
        return linear_model()
    depth = sum(1 for k in keys if k.startswith("w"))
    mlp_keys = {f"w{i}" for i in range(1, depth + 1)} | {
        f"b{i}" for i in range(1, depth)}
    if depth >= 2 and keys == mlp_keys:
        widths = tuple(int(params[f"w{i}"].shape[0])
                       for i in range(1, depth))
        return mlp_model(widths[0] if len(widths) == 1 else widths)
    raise ValueError(
        f"cannot infer a zoo model from parameter keys {sorted(keys)}; "
        "pass model=Model(...) explicitly — conv also needs input_dim=d "
        "(its 'w' head sees post-conv features, so the raw width is "
        "not inferable from the parameters)")


def _host_tensor(v) -> torch.Tensor:
    """A weight as a CPU tensor; float64 arrays become float32, as JAX
    (without x64) reads them."""
    t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))
    return t.float() if t.dtype == torch.float64 else t


class ServingEngine:
    """A warmed, rung-padded predictor over a trained checkpoint.

    ``predict`` accepts a ``(n, d)`` batch (or a single ``(d,)`` row),
    pads it to the rung ladder, runs the forward at that rung's shape,
    and returns the valid ``(n, C)`` logits as a host numpy array. The
    weights and the RFF draw are put on the device once, at install;
    per-call traffic is the padded input and the logits.

    ``device`` (not in the JAX signature): where a mesh-less engine
    serves — the card when None, ``"cpu"`` to serve on the CPU. With no
    card and no ``device="cpu"`` the constructor raises.
    """

    def __init__(self, params, model: Model | str = "auto", rff=None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, mesh=None,
                 feature_dtype=None, input_dim: int | None = None,
                 version: int = 0, device=None):
        self.model = infer_model(params) if model == "auto" else model
        if isinstance(self.model, str):
            from ..models import get_model

            self.model = get_model(self.model)
        self.mesh = mesh
        if mesh is None:
            self._devices = (resolve_device(device),)
        else:
            self._devices = tuple(mesh.devices)
        n_dev = len(self._devices)
        # mesh-even rungs: each device's slice of a rung must be one
        # fixed shape, so rungs round UP to a device multiple (never
        # down — a smaller rung would add a shape)
        ladder = sorted({-(-int(b) // n_dev) * n_dev for b in buckets})
        if not ladder or ladder[0] <= 0:
            raise ValueError(f"bad bucket ladder {buckets!r}")
        self.buckets = tuple(ladder)
        # ladder lifecycle lock (install_rung/retire_rung): the rung
        # set is published as ONE tuple swap under it, so a dispatch
        # reads a consistent ladder without taking any lock
        self._ladder_lock = threading.Lock()
        self._n_dev = n_dev
        if mesh is not None:
            from ..parallel.mesh import batch_spec

            self._in_spec = batch_spec(mesh, 2)
        else:
            self._in_spec = None
        self.feature_dtype = feature_dtype
        self._fdtype = _torch_dtype(feature_dtype)
        # versioned weight store: every entry serves through the same
        # ladder (weights are forward arguments). _weights maps version
        # -> (params, rff), each a tuple with one entry a device; _live
        # names the version a version=None dispatch resolves. One lock
        # guards both — the resolve in _resolve() and the flip in
        # swap_weights() are the atomicity the service's retry path
        # leans on.
        self._wlock = threading.Lock()
        self._weights: dict[int, tuple] = {}
        self._live = int(version)
        self.swap_count = 0
        self._weights[self._live] = self._prepare_weights(params, rff,
                                                          check=False)
        # computed ONCE: predict() checks it per dispatch, and the
        # swap-compatibility contract pins every version to the same
        # shapes, so the value can never go stale
        if input_dim is not None:
            self._input_dim = int(input_dim)
        elif self.rff is not None:
            self._input_dim = int(self.rff[0].shape[0])
        else:
            self._input_dim = int(
                self.params[self._weight_keys()[0]].shape[1])
        # the distinct padded shapes dispatched: compile_count's basis
        self._shapes_seen: set = set()
        self._shapes_lock = threading.Lock()
        # host-timed stage split of the most recent predict() call
        # (pad+transfer vs device dispatch), for the request-level
        # trace plane. Single-consumer by design (the serving worker
        # thread is the only reader, via pop_timings).
        self._timings: dict | None = None

    # -- versioned weight store ---------------------------------------
    def _prepare_weights(self, params, rff, check: bool = True) -> tuple:
        """Host parameters -> ``(params, rff)`` on every device of the
        engine, each a tuple with one entry a device (the rff entry
        ``(W, b, sqrt(D))``, or None). With ``check``, the prepared
        weights must be swap-compatible with the installed ones — same
        keys, shapes and dtypes, and the same rff-ness (whether the map
        is fused is part of the predictor, not data)."""
        host = {k: _host_tensor(v) for k, v in params.items()}
        host_rff = None
        if rff is not None:
            host_rff = (_host_tensor(rff[0]).float(),
                        _host_tensor(rff[1]).float())
        if check:
            ref_p, ref_r, _ = self._resolve(None)
            ref_p = ref_p[0]
            ref_r = None if ref_r is None else ref_r[0]
            if (host_rff is None) != (ref_r is None):
                raise ValueError(
                    "swap-incompatible weights: the engine was built "
                    f"{'with' if ref_r is not None else 'without'} a "
                    "fused RFF draw and the new version comes "
                    f"{'without' if host_rff is None else 'with'} one — "
                    "rff-ness is part of the predictor")
            if set(host) != set(ref_p):
                raise ValueError(
                    "swap-incompatible weights: parameter pytree "
                    "structure differs from the serving one (keys "
                    f"{sorted(host)} vs {sorted(ref_p)})")
            if any(tuple(host[k].shape) != tuple(ref_p[k].shape)
                   or host[k].dtype != ref_p[k].dtype for k in host):
                raise ValueError(
                    "swap-incompatible weights: a leaf's shape or "
                    "dtype differs from the serving version — a swap "
                    "must reuse the rung shapes, and these weights "
                    "would change them")
            if host_rff is not None and (
                    tuple(host_rff[0].shape) != tuple(ref_r[0].shape)
                    or tuple(host_rff[1].shape) != tuple(ref_r[1].shape)):
                raise ValueError(
                    "swap-incompatible weights: RFF draw shape differs "
                    "from the serving version")
        placed_p, placed_r = [], []
        for dev in self._devices:
            placed_p.append({k: v.to(dev) for k, v in host.items()})
            if host_rff is not None:
                W, b = (t.to(dev) for t in host_rff)
                placed_r.append((W, b, rff_scale(W.shape[1], dev)))
        return tuple(placed_p), (tuple(placed_r) if host_rff is not None
                                 else None)

    def _resolve(self, version: int | None) -> tuple:
        """``(params, rff, version)`` of one installed version — the
        LIVE one for ``version=None``, read atomically (one lock hold
        covers pointer + weights, so a concurrent swap can never hand
        out version k's params with version k+1's rff). ``params`` and
        ``rff`` hold one entry a device."""
        with self._wlock:
            v = self._live if version is None else int(version)
            try:
                params, rff = self._weights[v]
            except KeyError:
                raise KeyError(
                    f"model version {v} is not installed (have "
                    f"{sorted(self._weights)})") from None
        return params, rff, v

    def install_weights(self, version: int, params, rff=None) -> int:
        """Stage one more servable version WITHOUT routing traffic to
        it — how a rollout candidate gets device-resident next to the
        live version. Checked against the serving weights (a mismatch
        raises before anything is installed). Re-using an installed
        version number is refused: ``retire`` first to re-stage one."""
        version = int(version)
        prepared = self._prepare_weights(params, rff)
        with self._wlock:
            if version == self._live:
                raise ValueError(
                    f"version {version} is live; swap_weights is the "
                    "only way to change the serving weights")
            if version in self._weights:
                raise ValueError(
                    f"version {version} is already installed; retire "
                    "it first (a silent overwrite would serve "
                    "different weights under an already-vetted "
                    "version number)")
            self._weights[version] = prepared
        return version

    def swap_weights(self, params=None, rff=None,
                     version: int | None = None) -> int:
        """Make new weights live through the same ladder — the hot swap.
        ``swap_weights(params, rff=...)`` installs-and-flips (``version``
        names the new entry, default one past every installed one) and
        retires the replaced version; ``swap_weights(version=k)`` flips
        to an already-installed version (a staged rollout candidate
        being promoted). The flip itself is one pointer write under the
        weight lock; in-flight dispatches that already resolved keep
        their (consistent) old weights."""
        if params is None and version is None:
            raise ValueError("swap_weights needs params or version=")
        if params is not None:
            prepared = self._prepare_weights(params, rff)
            with self._wlock:
                # auto-version past EVERY installed entry (a staged
                # candidate occupies a slot), under the same lock hold
                # as the install+flip, so two concurrent auto-swaps
                # never race into one slot
                v = (max(self._weights) + 1 if version is None
                     else int(version))
                old = self._live
                if v == old:
                    raise ValueError(
                        f"version {v} is live; omit version= to "
                        "replace the serving weights under a fresh "
                        "number")
                if v in self._weights:
                    raise ValueError(
                        f"version {v} is already installed; retire it "
                        "first, or omit version= to auto-assign")
                self._weights[v] = prepared
                self._live = v
                self.swap_count += 1
                # install-and-flip REPLACES the serving weights: a
                # swap-per-round loop holds one version on the device,
                # not every generation
                self._weights.pop(old, None)
            return v
        v = int(version)
        with self._wlock:
            if v not in self._weights:
                raise KeyError(
                    f"model version {v} is not installed (have "
                    f"{sorted(self._weights)})")
            if v != self._live:
                self._live = v
                self.swap_count += 1
        return v

    def retire(self, version: int) -> None:
        """Drop an installed non-live version (its device memory frees
        once no in-flight dispatch holds it). Retiring the live version
        is refused, and retiring one that is not installed raises
        ``KeyError``."""
        version = int(version)
        with self._wlock:
            if version == self._live:
                raise ValueError(f"version {version} is live; swap "
                                 "first, then retire")
            if version not in self._weights:
                raise KeyError(
                    f"model version {version} is not installed (have "
                    f"{sorted(self._weights)})")
            del self._weights[version]

    @property
    def version(self) -> int:
        """The live version (what a ``version=None`` dispatch serves)."""
        with self._wlock:
            return self._live

    @property
    def versions_installed(self) -> list[int]:
        with self._wlock:
            return sorted(self._weights)

    @property
    def params(self):
        """The live version's parameters (on the first device)."""
        return self._resolve(None)[0][0]

    @property
    def rff(self):
        """The live version's ``(W, b)`` draw (on the first device), or
        None."""
        rff = self._resolve(None)[1]
        return None if rff is None else rff[0][:2]

    @property
    def device(self) -> torch.device:
        """The first (for a mesh-less engine, the only) device."""
        return self._devices[0]

    def _weight_keys(self) -> list[str]:
        # numeric layer order ("w2" before "w10"; bare "w" is layer 0)
        return sorted((k for k in self.params if k.startswith("w")),
                      key=lambda k: int(k[1:] or 0))

    @property
    def input_dim(self) -> int:
        """Raw feature width a request row must have: from the RFF draw
        or the first weight's fan-in, or ``input_dim=`` (conv)."""
        return self._input_dim

    @property
    def num_classes(self) -> int:
        return int(self.params[self._weight_keys()[-1]].shape[0])

    @property
    def compile_count(self) -> int:
        """Distinct padded input shapes dispatched — stable at
        ``len(self.buckets)`` after :meth:`warmup`. Nothing compiles in
        eager PyTorch; this is the JAX package's fallback basis for its
        jit-cache counter (one shape is one program there), kept so the
        same no-new-shape contract holds here."""
        with self._shapes_lock:
            return len(self._shapes_seen)

    @classmethod
    def load(cls, path: str, model: Model | str = "auto",
             buckets: Sequence[int] = DEFAULT_BUCKETS, mesh=None,
             rff=None, feature_dtype=None,
             input_dim: int | None = None,
             version: int = 0, state: dict | None = None,
             device=None) -> "ServingEngine":
        """Restore a ``save_checkpoint`` directory (the pickle layout;
        an orbax one raises ``CheckpointError``) into a ready engine. A
        checkpoint saved with its RFF draw (``rff_W``/``rff_b``) serves
        RAW inputs; otherwise pre-mapped features (or pass ``rff=(W,
        b)``). The checkpoint's ``feature_dtype`` marker applies unless
        ``feature_dtype`` is given.

        ``version`` seeds the live version number: in a rollout
        deployment, pass the checkpoint's REGISTRY version. A state with
        no ``params`` raises ``utils.checkpoint.CheckpointError`` naming
        the path. ``state``: the already-loaded checkpoint dict, so a
        large one is not read twice."""
        from ..utils.checkpoint import CheckpointError, load_checkpoint

        if state is None:
            state = load_checkpoint(path)
        if "params" not in state:
            raise CheckpointError(
                path, "state has no 'params' entry (not a "
                "save_checkpoint layout?); found keys "
                f"{sorted(state)!r}")
        if rff is None and "rff_W" in state and "rff_b" in state:
            rff = (state["rff_W"], state["rff_b"])
        if feature_dtype is None and "feature_dtype" in state:
            feature_dtype = str(state["feature_dtype"])
        return cls(state["params"], model=model, rff=rff,
                   buckets=buckets, mesh=mesh,
                   feature_dtype=feature_dtype, input_dim=input_dim,
                   version=version, device=device)

    @classmethod
    def from_artifact(cls, artifact_dir: str, checkpoint: str | None = None,
                      params=None, rff=None, model: Model | str = "auto",
                      version: int = 0) -> "ServingEngine":
        """The JAX package's cold start from an exported ladder. Not
        carried: raises ``NotImplementedError``."""
        raise NotImplementedError(f"ServingEngine.from_artifact {_NOT_PORTED}")

    def _forward(self, x: torch.Tensor, params: dict, rff) -> torch.Tensor:
        """The JAX engine's forward (``engine.py:181-193``): the RFF map
        when a draw is fused, the cast to ``feature_dtype``, the model."""
        if rff is not None:
            x = rff_map(x, rff[0], rff[1], scale=rff[2])
        if self._fdtype is not None:
            # parity with a narrow-feature training run, on the fused
            # path (after the map, as rff_map_to does) and on
            # pre-mapped inputs alike
            x = x.to(self._fdtype)
        return self.model.apply(params, x)

    def _dispatch(self, X: np.ndarray, params, rff) -> np.ndarray:
        """One padded rung: one host-to-device copy (a slice a device on
        a mesh), the forward, the logits back on the host (the copy back
        waits for the device, so the caller's timing is honest)."""
        with self._shapes_lock:
            self._shapes_seen.add(X.shape)
        with torch.inference_mode(), full_fp32():
            if self._in_spec is None:
                x = torch.from_numpy(X).to(self._devices[0])
                return self._forward(x, params[0], None if rff is None
                                     else rff[0]).cpu().numpy()
            outs = [self._forward(x, params[i], None if rff is None
                                  else rff[i])
                    for i, x in enumerate(self._in_spec.place(X))]
            return torch.cat([o.cpu() for o in outs]).numpy()

    def _run(self, X: np.ndarray, weights: tuple,
             timings: dict, ladder=None) -> np.ndarray:
        params, rff, v = weights
        t0 = time.perf_counter()
        n, d = X.shape
        # `ladder` is the caller's one-read snapshot of the rung tuple
        # (predict latches it): re-reading self.buckets here could see
        # a concurrent retire_rung and raise on a batch the latched
        # ladder covers
        b = bucket_for(n, self.buckets if ladder is None else ladder)
        if n < b:
            X = np.concatenate(
                [X, np.zeros((b - n, d), X.dtype)], axis=0)
        t1 = time.perf_counter()
        out = self._dispatch(np.ascontiguousarray(X), params, rff)[:n]
        t2 = time.perf_counter()
        # accumulate across an oversized request's max-rung chunks —
        # into the CALLER's local dict, never the shared slot mid-call
        timings["pad_s"] += t1 - t0
        timings["dispatch_s"] += t2 - t1
        timings["bucket"] = b
        timings["version"] = v
        return out

    def pop_timings(self) -> dict | None:
        """Host-timed stage split of the calls since the last pop:
        ``{"pad_s", "dispatch_s", "bucket", "version"}`` — padding vs
        the (blocking) copy, forward and copy back, plus WHICH model
        version answered — or None when nothing ran. Popping clears, so
        a stale split is never billed to the next batch."""
        t, self._timings = self._timings, None
        return t

    def predict(self, X, version: int | None = None,
                record_timings: bool = True) -> np.ndarray:
        """Logits for a ``(n, d)`` batch or ``(d,)`` row; any ``n`` —
        oversized batches are served in max-rung chunks. ``version``
        dispatches a specific installed version (a rollout candidate);
        None resolves the LIVE version atomically here, at dispatch
        time. ``record_timings=False`` keeps this call out of the
        single-consumer ``pop_timings`` slot (out-of-band dispatches on
        other threads, such as the rollout parity gate)."""
        weights = self._resolve(version)
        X = np.asarray(X, dtype=np.float32)
        timings = {"pad_s": 0.0, "dispatch_s": 0.0, "bucket": 0,
                   "version": weights[2]}
        single = X.ndim == 1
        if single:
            X = X[None, :]
        if X.ndim != 2 or X.shape[1] != self.input_dim:
            raise ValueError(
                f"expected (n, {self.input_dim}) rows, got {X.shape}")
        # ONE ladder read for the whole call: chunking decision and
        # rung choice must agree even while install_rung/retire_rung
        # swap the tuple concurrently
        ladder = self.buckets
        top = ladder[-1]
        if X.shape[0] <= top:
            out = self._run(X, weights, timings, ladder)
        else:
            out = np.concatenate(
                [self._run(X[lo:lo + top], weights, timings, ladder)
                 for lo in range(0, X.shape[0], top)], axis=0)
        if record_timings:
            # one reference assignment AFTER the call completed
            self._timings = timings
        return out[0] if single else out

    def device_attribution(self, reps: int = 8,
                           bucket: int | None = None,
                           seed: int = 0) -> dict:
        """Sampled device-time attribution of this engine's dispatch:
        ``reps`` dispatches of one rung (the middle one by default)
        under one ``torch.profiler`` capture, the capture's GPU busy
        time set against the host-blocking dispatch time
        (``utils.telemetry.attribute_device_time``). Out-of-band: the
        dispatches run with ``record_timings=False``. On the CPU (no GPU
        event in the capture) the result is ``source="none"`` with the
        reason."""
        from ..utils.telemetry import attribute_device_time

        b = int(bucket) if bucket is not None \
            else self.buckets[len(self.buckets) // 2]
        if b not in self.buckets:
            raise ValueError(
                f"bucket {b} is not a ladder rung {self.buckets}")
        X = np.random.RandomState(seed).randn(
            b, self.input_dim).astype(np.float32)

        def dispatch() -> float:
            t0 = time.perf_counter()
            self.predict(X, record_timings=False)
            return time.perf_counter() - t0

        attr = attribute_device_time(dispatch, reps=reps)
        attr["bucket"] = b
        return attr

    # -- ladder lifecycle ---------------------------------------------
    def _warm_shape(self, b: int) -> None:
        """Run the predictor at rung ``b`` on zeros, on the CALLER's
        thread, so :meth:`install_rung` publishes only warm rungs (the
        library's first call at a shape picks its algorithm and sizes
        its workspace off the hot path)."""
        params, rff, _ = self._resolve(None)
        self._dispatch(np.zeros((b, self.input_dim), np.float32), params,
                       rff)

    def install_rung(self, bucket: int, aot=None) -> int:
        """Atomically grow the ladder by one rung, warmed BEFORE it is
        published (one tuple swap under the ladder lock). Call it from
        any thread EXCEPT the serving worker. Returns the installed rung
        size (rounded up to a mesh-device multiple). ``aot=`` (a rung
        executable of the JAX artifact plane) is not carried and raises
        ``NotImplementedError``."""
        if aot is not None:
            raise NotImplementedError(f"install_rung(aot=...) {_NOT_PORTED}")
        b = -(-int(bucket) // self._n_dev) * self._n_dev
        if b <= 0:
            raise ValueError(f"rung must be positive, got {bucket}")
        if b in self.buckets:
            raise ValueError(f"{b} is already a ladder rung "
                             f"{self.buckets}")
        self._warm_shape(b)
        with self._ladder_lock:
            if b in self.buckets:
                raise ValueError(
                    f"{b} is already a ladder rung {self.buckets} "
                    "(concurrent install)")
            self.buckets = tuple(sorted(set(self.buckets) | {b}))
        return b

    def retire_rung(self, bucket: int) -> None:
        """Atomically drop a rung from the ladder (requests that would
        have used it pad up to the next rung, or chunk at the new top).
        Its shape stays counted — an in-flight dispatch that read the
        old ladder still serves at it — so ``compile_count`` never
        moves. Refuses to retire the last rung."""
        b = int(bucket)
        with self._ladder_lock:
            if b not in self.buckets:
                raise KeyError(
                    f"{b} is not a ladder rung {self.buckets}")
            if len(self.buckets) == 1:
                raise ValueError(
                    f"{b} is the last rung; the ladder must keep at "
                    "least one")
            self.buckets = tuple(x for x in self.buckets if x != b)

    def warmup(self) -> int:
        """Run every rung once (zeros input); returns ``compile_count``,
        after which a mixed-size stream dispatches no new shape."""
        d = self.input_dim
        weights = self._resolve(None)
        scratch = {"pad_s": 0.0, "dispatch_s": 0.0}
        for b in self.buckets:
            self._run(np.zeros((b, d), np.float32), weights, scratch)
        return self.compile_count


def _torch_dtype(feature_dtype):
    """``feature_dtype`` as a torch dtype: None, a torch dtype, or a name
    (``"bfloat16"``, the checkpoint marker; a numpy-style dtype object
    whose ``str`` is the name)."""
    if feature_dtype is None or isinstance(feature_dtype, torch.dtype):
        return feature_dtype
    name = str(getattr(feature_dtype, "name", feature_dtype))
    name = name.removeprefix("torch.")
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown feature_dtype {feature_dtype!r}")
    return dt
