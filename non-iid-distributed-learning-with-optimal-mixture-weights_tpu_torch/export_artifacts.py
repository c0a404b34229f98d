"""Export a checkpoint's serving bucket ladder as a cold-start artifact.

The port's counterpart of the repository's ``tools/export_artifacts.py``,
over this package's serving plane (``serving/artifacts.py``): point it
at a ``save_checkpoint`` directory and it builds the engine, exports
every rung of the bucket ladder once and writes the ladder
(``rung_<b>.pt2``, one ``torch.export`` program a rung, and the
``SERVE_ARTIFACT_TORCH.v1`` manifest with the host fingerprint) into
OUT_DIR. A replica then cold-starts with
``ServingEngine.from_artifact(OUT_DIR, checkpoint=CKPT)`` with
``compile_count == 0``.

Run from the repository root::

    python -m fedamw_tpu_torch.export_artifacts CKPT_DIR OUT_DIR \\
        [--buckets 1,8,64,512,4096] [--model auto] [--input-dim N] \\
        [--feature-dtype DT] [--round N] [--version N] [--check] \\
        [--device cpu]

The engine serves on the card unless ``--device`` names another device,
and the artifact is bound to that device's host class; with no card it
raises rather than falling back to the CPU.

``--check`` round-trips the artifact at once: ``from_artifact`` and one
seeded dispatch per rung, the logits bitwise the engine's, and nothing
dispatched through the eager path at load. The last line on stdout is
the JSON summary (rungs, bytes, timings, fingerprint) a deploy script
parses.

Exit status: 0 on success; 1 with a ``#`` line on stderr on a checkpoint
that does not load or a failed check (a typed ``ArtifactIncompatible``
here can only mean that the host changed between export and check).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .serving import ServingEngine
from .serving.artifacts import ArtifactIncompatible, export_ladder
from .utils.checkpoint import CheckpointError, load_checkpoint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fedamw_tpu_torch.export_artifacts",
        description="export a checkpoint's serving bucket ladder as "
                    "a cold-start artifact")
    ap.add_argument("checkpoint", help="save_checkpoint directory")
    ap.add_argument("out_dir", help="artifact directory to write")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated bucket ladder (default: the "
                         "engine default 1,8,64,512,4096)")
    ap.add_argument("--model", default="auto",
                    help="model zoo name (default: infer from the "
                         "checkpoint's parameters)")
    ap.add_argument("--input-dim", type=int, default=None,
                    help="raw feature width (conv checkpoints only — "
                         "not inferable from the parameters)")
    ap.add_argument("--feature-dtype", default=None,
                    help="feature dtype of the training run "
                         "(prepare_setup(feature_dtype=...)); the "
                         "checkpoint's own marker wins when present")
    ap.add_argument("--round", type=int, default=None, dest="round_idx",
                    help="training round to stamp as provenance "
                         "(default: the checkpoint's own marker)")
    ap.add_argument("--version", type=int, default=None,
                    help="registry model version to stamp as provenance")
    ap.add_argument("--check", action="store_true",
                    help="round-trip the artifact after export: "
                         "from_artifact + one dispatch per rung, "
                         "bitwise parity vs the engine, "
                         "compile_count == 0")
    ap.add_argument("--device", default=None,
                    help="torch device the engine serves from (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)

    kw = {}
    if args.buckets:
        kw["buckets"] = tuple(
            int(b) for b in args.buckets.split(","))
    try:
        # one disk read serves both the engine build and the round
        # marker (state= hands the loaded dict through)
        state = load_checkpoint(args.checkpoint)
        engine = ServingEngine.load(
            args.checkpoint, model=args.model, input_dim=args.input_dim,
            feature_dtype=args.feature_dtype, state=state,
            device=args.device, **kw)
    except CheckpointError as e:
        print(f"# export_artifacts: cannot load checkpoint: {e}",
              file=sys.stderr)
        return 1
    round_idx = args.round_idx
    if round_idx is None:
        round_idx = state.get("round")

    t0 = time.perf_counter()
    manifest = export_ladder(engine, args.out_dir,
                             model_version=args.version,
                             round_idx=round_idx)
    export_s = time.perf_counter() - t0
    summary = {
        "artifact": os.path.abspath(args.out_dir),
        "schema": manifest.schema,
        "buckets": manifest.buckets,
        "rungs": len(manifest.rungs),
        "bytes": sum(r["bytes"] for r in manifest.rungs.values()),
        "export_s": round(export_s, 3),
        "host": manifest.host,
        "round_idx": manifest.round_idx,
        "model_version": manifest.model_version,
    }

    if args.check:
        try:
            t0 = time.perf_counter()
            loaded = ServingEngine.from_artifact(
                args.out_dir, checkpoint=args.checkpoint,
                model=args.model, device=args.device)
            load_s = time.perf_counter() - t0
        except ArtifactIncompatible as e:
            print(f"# export_artifacts: check FAILED: {e}",
                  file=sys.stderr)
            return 1
        rng = np.random.RandomState(0)
        for b in loaded.buckets:
            X = rng.randn(b, loaded.input_dim).astype(np.float32)
            want = engine.predict(X)
            got = loaded.predict(X)
            if not np.array_equal(want, got):
                print(f"# export_artifacts: check FAILED: rung {b} "
                      "logits differ from the engine",
                      file=sys.stderr)
                return 1
        if loaded.compile_count != 0:
            print("# export_artifacts: check FAILED: artifact load "
                  f"path dispatched {loaded.compile_count} eager "
                  "shape(s); the cold-start contract is zero",
                  file=sys.stderr)
            return 1
        summary["check"] = {"load_s": round(load_s, 4),
                            "compile_count": loaded.compile_count,
                            "parity": "bitwise"}

    print(json.dumps(summary))
    print(f"# exported {summary['rungs']} rungs "
          f"({summary['bytes']} bytes) in {export_s:.2f}s -> "
          f"{summary['artifact']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
