"""Post-hoc paper tooling: significance tests, LaTeX table emitters and
the one-line reports the drivers print.

A copy of the JAX package's ``utils/reporting.py`` (numpy and stdlib
only): the same functions give the same strings and dicts on the same
inputs. Reference ``functions/utils.py:351-378`` (``check_significance``,
``print_acc``, ``print_time``) and the trivial flushing ``Logger``
(``utils.py:25-30``) operate on the ``(algorithms, n_repeats)``
accuracy/time matrices of the experiment driver; the trace summary reads
``utils.trace`` records; the fault, defense and serving formatters read
the records of those planes, which the port carries as it grows them
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import pickle

import numpy as np

# Paired one-sided t threshold the reference hard-codes (~t_{0.05, df=10}).
T_THRESHOLD = 1.812


def check_significance(test_arr, best_arr, threshold: float = T_THRESHOLD) -> bool:
    """True when ``best_arr`` significantly beats ``test_arr`` (paired
    t-statistic above the threshold) — reference ``utils.py:351-353``."""
    diff = np.asarray(best_arr, dtype=float) - np.asarray(test_arr, dtype=float)
    denom = np.std(diff) / np.sqrt(len(diff))
    if denom == 0:
        # zero variance: a constant positive gap is inf/denominator in the
        # reference (-> significant); identical rows are 0/0 (-> not)
        return bool(np.mean(diff) > 0)
    return float(np.mean(diff) / denom) > threshold


def print_acc(matrix) -> str:
    """LaTeX row: best row bold, rows NOT significantly worse underlined
    (reference ``utils.py:355-367``)."""
    matrix = np.asarray(matrix, dtype=float)
    best_index = int(np.argmax(np.mean(matrix, axis=1)))
    best_row = matrix[best_index]
    out = []
    for i, row in enumerate(matrix):
        cell = f"{row.mean():.2f}$\\pm${row.std():.2f}"
        if i == best_index:
            out.append("&\\textbf{" + cell + "} ")
        elif check_significance(row, best_row):
            out.append("&" + cell + " ")
        else:
            out.append("&\\underline{" + cell + "} ")
    return "".join(out)


def print_time(matrix) -> str:
    """LaTeX row of mean times, fastest bold (reference ``utils.py:369-378``)."""
    matrix = np.asarray(matrix, dtype=float)
    best_index = int(np.argmin(np.mean(matrix, axis=1)))
    out = []
    for i, row in enumerate(matrix):
        cell = f"{row.mean():.2f}"
        out.append("&\\textbf{" + cell + "} " if i == best_index else "&" + cell + " ")
    return "".join(out)


def fault_summary(fault_counts: dict) -> dict:
    """Aggregate a ``fault_counts`` record (the per-round dropped /
    straggled / corrupted / quarantined vectors a faulted run's result
    carries, ``algorithms.core._round_based``) into run totals:
    per-kind totals, the worst single round, and how many rounds saw
    any fault at all."""
    kinds = ("dropped", "straggled", "corrupted", "quarantined")
    arrs = {k: np.asarray(fault_counts[k], dtype=int) for k in kinds}
    # "lied" (work-fraction liars, fedcore.faults lie=) is optional so
    # records from before the reputation plane still summarize
    if "lied" in fault_counts:
        arrs["lied"] = np.asarray(fault_counts["lied"], dtype=int)
    any_fault = sum(arrs[k] for k in arrs if k != "quarantined")
    return {
        **{f"total_{k}": int(arrs[k].sum()) for k in arrs},
        "rounds": int(next(iter(arrs.values())).shape[0]),
        "rounds_with_faults": int(np.count_nonzero(any_fault)),
        "worst_round_faults": int(any_fault.max()) if any_fault.size else 0,
    }


def format_fault_report(name: str, fault_counts: dict) -> str:
    """One human-readable line per algorithm for the driver's stdout
    (``exp.py`` prints this after each faulted run): totals plus the
    invariant the quarantine is supposed to hold — every non-finite
    report caught (quarantined >= corrupted for nan/inf modes)."""
    s = fault_summary(fault_counts)
    lied = (f"{s['total_lied']} lied-frac, " if s.get("total_lied")
            else "")
    return (f"{name} faults: {s['total_dropped']} dropped, "
            f"{s['total_straggled']} straggled, "
            f"{s['total_corrupted']} corrupted, {lied}"
            f"{s['total_quarantined']} quarantined over "
            f"{s['rounds_with_faults']}/{s['rounds']} rounds "
            f"(worst round: {s['worst_round_faults']} faulty clients)")


def defense_summary(defense: dict) -> dict:
    """Aggregate a ``defense`` record (the per-round telemetry an
    active ``robust_agg`` spec attaches to a run's result,
    ``algorithms.core._round_based``) into run totals: scored-
    quarantine totals and the hottest z score, krum pick spread
    (which clients the selection trusted most/least), and the
    final/worst Weiszfeld residual. Only the keys the spec actually
    emitted appear."""
    out = {"robust_agg": defense["robust_agg"]}
    if "z_quarantined" in defense:
        zq = np.asarray(defense["z_quarantined"], dtype=int)
        out["total_z_quarantined"] = int(zq.sum())
        out["rounds_with_z_quarantine"] = int(np.count_nonzero(zq))
        out["max_z"] = float(np.max(defense["z_max"]))
    if "z_threshold" in defense:
        # quarantine:auto — where the auto-tuned threshold started and
        # where the observed clean-z distribution steered it
        thr = np.asarray(defense["z_threshold"], dtype=float)
        out["z_threshold_first"] = float(thr[0])
        out["z_threshold_final"] = float(thr[-1])
    if "reputation" in defense:
        rep = np.asarray(defense["reputation"], dtype=float)
        valid = np.asarray(
            defense.get("client_valid", np.ones(rep.shape[1])),
            dtype=bool)
        idx = np.flatnonzero(valid)
        final = rep[-1][idx]
        out["rep_final_mean"] = float(final.mean())
        out["rep_least_trusted"] = (int(idx[final.argmin()]),
                                    float(final.min()))
        rg = np.asarray(defense["rep_gated"], dtype=int)
        out["total_rep_gated"] = int(rg.sum())
        out["rounds_with_rep_gate"] = int(np.count_nonzero(rg))
    if "frac_clamped" in defense:
        fc = np.asarray(defense["frac_clamped"], dtype=int)
        out["total_frac_clamped"] = int(fc.sum())
    if "krum_pick_counts" in defense:
        picks = np.asarray(defense["krum_pick_counts"], dtype=int)
        # restrict the per-client stats to REAL clients: inert padded
        # ones (mesh-even packing; 'client_valid' from the run's
        # sizes) are never present and must not be reported as
        # "never selected"
        valid = np.asarray(
            defense.get("client_valid", np.ones_like(picks)),
            dtype=bool)
        idx = np.flatnonzero(valid)
        vp = picks[idx]
        out["krum_most_picked"] = (int(idx[vp.argmax()]),
                                   int(vp.max()))
        out["krum_least_picked"] = (int(idx[vp.argmin()]),
                                    int(vp.min()))
        out["krum_never_picked"] = int(np.sum(vp == 0))
    if "geomed_residual" in defense:
        res = np.asarray(defense["geomed_residual"], dtype=float)
        out["geomed_final_residual"] = float(res[-1])
        out["geomed_worst_residual"] = float(res.max())
    return out


def format_defense_report(name: str, defense: dict) -> str:
    """One human-readable line per algorithm for the driver's stdout
    (``exp.py`` prints this after each defended run), mirroring
    :func:`format_fault_report` for the defense side: what the spec
    was, what the scored quarantine caught, whom krum trusted, and
    whether Weiszfeld converged."""
    s = defense_summary(defense)
    bits = [f"{name} defense [{s['robust_agg']}]:"]
    if "total_z_quarantined" in s:
        bits.append(
            f"{s['total_z_quarantined']} z-quarantined over "
            f"{s['rounds_with_z_quarantine']} rounds "
            f"(max z {s['max_z']:.2f})")
    if "z_threshold_final" in s:
        bits.append(
            f"auto z threshold {s['z_threshold_first']:.2f} -> "
            f"{s['z_threshold_final']:.2f}")
    if "rep_final_mean" in s:
        li, lv = s["rep_least_trusted"]
        bits.append(
            f"reputation: mean {s['rep_final_mean']:.2f} final, "
            f"client {li} least trusted at {lv:.2f}, "
            f"{s['total_rep_gated']} rep-gated over "
            f"{s['rounds_with_rep_gate']} rounds")
    if "total_frac_clamped" in s:
        bits.append(
            f"{s['total_frac_clamped']} work-fraction claims clamped")
    if "krum_most_picked" in s:
        mi, mc = s["krum_most_picked"]
        li, lc = s["krum_least_picked"]
        bits.append(
            f"krum picks: client {mi} x{mc} most, client {li} x{lc} "
            f"least, {s['krum_never_picked']} never selected")
    if "geomed_final_residual" in s:
        bits.append(
            f"weiszfeld residual {s['geomed_final_residual']:.2e} "
            f"final / {s['geomed_worst_residual']:.2e} worst")
    return " ".join(bits) if len(bits) > 1 else (
        bits[0] + " active (no per-round telemetry for this spec)")


def trace_stage_summary(records) -> dict:
    """Aggregate trace span records (``utils.trace``) per stage name:
    count, total seconds, and mean/p50/p95 milliseconds. Annotations
    (zero-duration point events) are counted separately per name so a
    retry storm is visible next to the stage it hit."""
    stages: dict[str, list] = {}
    notes: dict[str, int] = {}
    for r in records:
        if r.get("kind") == "annotation":
            notes[r["name"]] = notes.get(r["name"], 0) + 1
        else:
            stages.setdefault(r["name"], []).append(float(r["dur_s"]))
    out = {}
    for name, durs in stages.items():
        a = np.asarray(durs, dtype=float)
        # nearest-rank percentiles, the same method
        # serving.metrics.LatencyHistogram uses
        p50, p95 = np.percentile(a, [50, 95], method="inverted_cdf")
        out[name] = {
            "count": int(a.size),
            "total_s": round(float(a.sum()), 6),
            "mean_ms": round(float(a.mean()) * 1e3, 4),
            "p50_ms": round(float(p50) * 1e3, 4),
            "p95_ms": round(float(p95) * 1e3, 4),
        }
    return {"stages": out, "annotations": notes}


def format_trace_summary(label: str, records) -> str:
    """Human-readable per-stage table for a trace (the trace-plane
    mirror of :func:`format_fault_report`): one line per stage with
    count / total / mean / p50 / p95, stages sorted by total cost so
    the expensive one reads first, annotations footed below. Printed by
    ``exp.py --trace_dir`` and ``serve_bench.py``'s traced leg."""
    s = trace_stage_summary(records)
    if not s["stages"] and not s["annotations"]:
        return f"{label} trace: no spans recorded"
    lines = [f"{label} trace ({sum(v['count'] for v in s['stages'].values())}"
             f" spans):"]
    width = max((len(n) for n in s["stages"]), default=0)
    for name, st in sorted(s["stages"].items(),
                           key=lambda kv: -kv[1]["total_s"]):
        lines.append(
            f"  {name:<{width}}  x{st['count']:<6d} "
            f"total {st['total_s']:9.3f}s  mean {st['mean_ms']:9.3f}ms  "
            f"p50 {st['p50_ms']:9.3f}ms  p95 {st['p95_ms']:9.3f}ms")
    for name, n in sorted(s["annotations"].items()):
        lines.append(f"  ! {name}: {n} event(s)")
    return "\n".join(lines)


def format_rollout_report(rollout: dict) -> str:
    """One human-readable line for a continuous-deployment leg (the
    ``rollout`` section ``serve_bench.py`` emits — swap latency,
    canary/drill verdicts, the hot-swap zero-recompile pin, and where
    the service ended up relative to training): the serve-side mirror
    of :func:`format_fault_report`."""
    bits = [f"rollout [{rollout.get('mode', '?')}]:",
            f"{rollout['swaps']} swaps"]
    if rollout.get("swap_p50_ms") is not None:
        bits.append(f"(p50 {rollout['swap_p50_ms']}ms, max "
                    f"{rollout.get('swap_max_ms')}ms)")
    if "canary" in rollout:
        canary_ms = rollout.get("canary_ms")
        bits.append(f"canary {rollout['canary']}"
                    + (f" in {canary_ms}ms" if canary_ms else ""))
    if rollout.get("rollback_drill"):
        bits.append(f"drill {rollout['rollback_drill']}")
    bits.append(f"in-flight p95 {rollout.get('inflight_p95_ms')}ms")
    bits.append(
        f"recompiles {rollout.get('recompiles_during_swaps')}")
    if "final_version" in rollout:
        bits.append(f"serving v{rollout['final_version']} "
                    f"({rollout.get('staleness_rounds', 0)} rounds "
                    "behind newest)")
    return " ".join(str(b) for b in bits)


def format_failover_report(chaos: dict) -> str:
    """One human-readable line for a chaos-injected failover leg (the
    ``chaos`` section ``serve_bench.py`` emits — replica deaths,
    requeues, hedge wins, the tail with and without chaos, and the
    zero-lost / zero-recompile pins): the failover-plane mirror of
    :func:`format_rollout_report`."""
    bits = [f"chaos [{chaos.get('replicas', '?')} replicas]:",
            f"{chaos.get('kills_observed', 0)}/"
            f"{chaos.get('kills_planned', 0)} kills",
            f"{chaos.get('requeues', 0)} requeues",
            f"{chaos.get('hedge_wins', 0)}/{chaos.get('hedges', 0)} "
            "hedge wins"]
    bits.append(f"{chaos.get('resolved_ok', 0)} ok + "
                f"{chaos.get('deadline_exceeded', 0)} deadline of "
                f"{chaos.get('requests', 0)} "
                f"({chaos.get('lost', '?')} lost)")
    bits.append(f"p95 {chaos.get('p95_ms_chaos')}ms vs "
                f"{chaos.get('p95_ms_clean')}ms clean")
    bits.append(f"recompiles {chaos.get('recompiles_during_chaos')}")
    return " ".join(str(b) for b in bits)


def format_overload_report(ov: dict) -> str:
    """One human-readable line for the elastic-serving overload leg
    (the ``overload`` section ``serve_bench.py`` emits — the
    autoscaled fleet's SLO-good-per-replica-second against every
    fixed fleet, interactive protection, shed and scale counters):
    the control-plane mirror of :func:`format_failover_report`."""
    fleets = ov.get("fleets", {})
    auto = fleets.get("autoscaled", {})
    fixed = {name: rec.get("good_per_replica_s")
             for name, rec in sorted(fleets.items())
             if name != "autoscaled"}
    bits = [
        "overload:",
        f"autoscaled {auto.get('good_per_replica_s')} good/replica-s "
        f"vs fixed {fixed}",
        f"(beats all: {ov.get('autoscaled_beats_every_fixed')})",
        f"interactive attainment "
        f"{auto.get('attainment', {}).get('interactive')}",
        f"batch shed {ov.get('batch_shed', 0)}",
        f"scale-ups {ov.get('scale_ups', 0)} "
        f"(peak {auto.get('replicas_peak')})",
        f"lost {ov.get('lost_accepted', 0)}",
        f"recompiles {ov.get('recompiles_during_overload', 0)}",
    ]
    return " ".join(str(b) for b in bits)


def load_results(path: str) -> dict:
    """Load an ``exp1_{dataset}.pkl`` result dict (driver schema)."""
    with open(path, "rb") as f:
        return pickle.load(f)


class Logger:
    """Line-buffered file logger (reference ``utils.py:25-30``)."""

    def __init__(self, filename: str):
        self.log = open(filename, "w")

    def write(self, content: str) -> None:
        self.log.write(content)
        self.log.flush()
