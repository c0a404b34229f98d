"""Host-to-device double-buffered client-shard streaming.

The streamed half of the cohort plane (``fedcore.hierarchy``; JAX
``data/stream.py``). When the stacked client axis no longer fits next to
the model on the card, the ``O(J)`` per-client rows (packed index sets,
validity masks, sizes, fixed weights, the round's fault-plan rows, and
the injected shuffles where a caller gives them) stay on the HOST, and
each round walks the cohort in ``n_shards`` contiguous equal shards.

On a CUDA device the host rows sit in pinned memory and each shard is
copied into one of two device buffers on a copy stream of its own: shard
``s + 1`` is copied while shard ``s`` computes, the compute stream waits
on the copy's event before it reads a shard, and the copy into a buffer
waits on the event recorded when the compute queued on the buffer's
previous shard, so a buffer is never overwritten while a kernel still
reads it. At most two shards' rows are on the device at once, in the
same two buffers every round. The port draws its shuffles on the device,
so no PRNG keys are streamed.

On the CPU (``device`` is the CPU, as in the tests) a shard is a plain
slice of the host rows: nothing is pinned, since pinning needs CUDA.

Shards are contiguous and equal-sized (``J`` must divide evenly; pad the
cohort with inert empty clients through
``prepare_setup(client_multiple=n_shards)`` otherwise), so every shard
has one shape and the device buffers are allocated once.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a, pin: bool) -> torch.Tensor:
    """A contiguous CPU tensor of ``a`` (tensor or array), pinned when
    ``pin``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    t = t.detach().cpu().contiguous()
    return t.pin_memory() if pin and not t.is_pinned() else t


class CohortShardStream:
    """Double-buffered iterator over contiguous client shards.

    ``idx``/``mask`` are the single-pack ``(J, n_max)`` client rows (the
    bucketed layout re-sorts clients and has one shape per bucket, so
    streaming needs ``buckets=1``), ``sizes``/``p_fixed`` the ``(J,)``
    per-client vectors; tensors or arrays, on any device: a host copy is
    kept (pinned for a CUDA ``device``) and nothing ``O(J)`` stays on the
    device in full. ``device`` (default: the CPU) is where the shards go.
    """

    def __init__(self, n_shards: int, idx, mask, sizes, p_fixed,
                 device=None):
        self.device = torch.device("cpu" if device is None else device)
        self._cuda = self.device.type == "cuda"
        self._rows = {k: _host(v, self._cuda) for k, v in (
            ("idx", idx), ("mask", mask), ("sizes", sizes),
            ("p_fixed", p_fixed))}
        J = self._rows["idx"].shape[0]
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if J % n_shards != 0:
            raise ValueError(
                f"the {J}-client cohort does not divide into "
                f"{n_shards} equal shards; pad with inert empty "
                f"clients (prepare_setup(client_multiple={n_shards})) "
                "so every shard has one shape")
        self.n_shards = int(n_shards)
        self.shard_clients = J // self.n_shards
        self._bufs = [{}, {}]
        if self._cuda:
            self._copy = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._done = [None, None]
        # (event before, event after) the compute stream's wait on each
        # shard's copy, for copy_wait_ms
        self._waits = []

    @property
    def num_clients(self) -> int:
        return self._rows["idx"].shape[0]

    def _put(self, s: int, per_round: dict) -> dict:
        """Shard ``s``'s rows: a slice on the CPU; on CUDA, copies queued
        on the copy stream into buffer ``s % 2``."""
        sl = slice(s * self.shard_clients, (s + 1) * self.shard_clients)
        src = {k: v[sl] for k, v in self._rows.items()}
        src.update({k: v[sl] for k, v in per_round.items()})
        if not self._cuda:
            return src
        b, buf = s % 2, self._bufs[s % 2]
        with torch.cuda.stream(self._copy):
            if self._done[b] is not None:
                # the compute queued on this buffer's previous shard
                self._copy.wait_event(self._done[b])
            for k, v in src.items():
                if k not in buf:
                    buf[k] = torch.empty(v.shape, dtype=v.dtype,
                                         device=self.device)
                buf[k].copy_(v, non_blocking=True)
            self._copied[b].record(self._copy)
        return buf

    def round_shards(self, fault_rows=None, positions=None):
        """Yield ``(s, shard)`` for one round, one shard of copy
        lookahead. ``shard`` holds ``idx``, ``mask``, ``sizes`` and
        ``p_fixed``, with ``fault_rows`` (the round's ``(drop, scale,
        poison, fill, tau_frac)`` rows, each ``(J,)``) when given, and
        ``positions`` (the round's injected shuffles, ``(J, epochs, S,
        B)``) when given; on CUDA the row tensors should be pinned (a
        pageable source is pinned first, once per call).

        On CUDA the yielded tensors are the two device buffers: valid for
        the work the caller queues on the current stream before the next
        shard is asked for, and overwritten after it."""
        per_round = {}
        if fault_rows is not None:
            per_round.update({f"fault_{i}": _host(r, self._cuda)
                              for i, r in enumerate(fault_rows)})
        if positions is not None:
            per_round["positions"] = _host(positions, self._cuda)
        compute = (torch.cuda.current_stream(self.device) if self._cuda
                   else None)
        nxt = self._put(0, per_round)
        for s in range(self.n_shards):
            cur = nxt
            if s + 1 < self.n_shards:
                nxt = self._put(s + 1, per_round)
            if compute is not None:
                before = torch.cuda.Event(enable_timing=True)
                after = torch.cuda.Event(enable_timing=True)
                before.record(compute)
                compute.wait_event(self._copied[s % 2])
                after.record(compute)
                self._waits.append((before, after))
            shard = {k: cur[k] for k in ("idx", "mask", "sizes", "p_fixed")}
            if fault_rows is not None:
                shard["fault_rows"] = tuple(
                    cur[f"fault_{i}"] for i in range(len(fault_rows)))
            if positions is not None:
                shard["positions"] = cur["positions"]
            yield s, shard
            if compute is not None:
                done = torch.cuda.Event()
                done.record(compute)
                self._done[s % 2] = done

    def copy_wait_ms(self) -> float:
        """Milliseconds the compute stream spent waiting on shard copies
        over every round so far (0 on the CPU): for each shard, the time
        between the events recorded just before and just after its wait.
        Synchronises the device."""
        if not self._waits:
            return 0.0
        torch.cuda.synchronize(self.device)
        return float(sum(a.elapsed_time(b) for a, b in self._waits))
