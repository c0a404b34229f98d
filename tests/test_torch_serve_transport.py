"""The port's dispatch transports against the JAX package's, and pod
workers in spawned processes, on the CPU.

``fedamw_tpu_torch.serving.transport`` is a copy of the JAX package's
``serving/transport.py``; its frame layer works on numpy bytes on the
host. Held here:

- **The wire.** The frame bytes of ``write_frame`` (dispatch, control
  and weight frames), ``pack_batch``, ``pack_weights``' arrays and
  ``weights_fingerprint`` equal the JAX package's for the same arrays
  under the same key names (weights through ``convert.params_from_jax``
  and back); malformed frames raise the JAX package's types and
  messages.
- **In process.** A ``PodWorker`` over the port's engine answers
  bitwise its direct call, serves its live weights (tensors, crossed to
  numpy at the engine boundary) to a ``sync`` frame under the JAX
  fingerprint, and installs a tensor announce.
- **Spawned workers.** Two ``worker_main`` processes, each started in a
  fresh interpreter (the ``spawn`` context: a process that has touched
  CUDA cannot fork a child that uses it), cold-start from one exported
  ladder with ``device="cpu"``: each answers bitwise the in-process
  ``predict`` with ``compile_count`` 0; one ``swap_weights`` announce
  lands both on one version; a SIGKILL of one mid-batch requeues the
  batch to the other within its deadline; the dead endpoint then
  fast-fails inside its reconnect backoff.

A ``cuda`` case spawns a worker on the card.
"""

import multiprocessing
import os
import signal
import socket
import time

import numpy as np
import pytest
import torch

import fedamw_tpu.serving.transport as jtransport
import fedamw_tpu_torch.serving.transport as ttransport
from fedamw_tpu_torch.convert import params_from_jax
from fedamw_tpu_torch.serving import (FailoverRouter, FrameError,
                                      NetChaosPlan, PodClientEngine,
                                      PodWorker, Replica, ServingEngine,
                                      SocketTransport, TransportError,
                                      TransportRefused, export_ladder,
                                      weights_fingerprint, worker_main)
from fedamw_tpu_torch.utils.checkpoint import save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

D, C = 16, 3
BUCKETS = (1, 8, 32)


def rows(n, seed=5):
    return np.random.RandomState(seed).randn(n, D).astype(np.float32)


def _params(seed=1):
    return {"w": np.random.RandomState(seed).randn(C, D).astype(np.float32)}


def _wire(mod, header, payload=b""):
    """The bytes ``mod.write_frame`` puts on a socket."""
    a, b = socket.socketpair()
    try:
        mod.write_frame(a, header, payload)
        a.close()
        chunks = []
        while True:
            got = b.recv(1 << 16)
            if not got:
                return b"".join(chunks)
            chunks.append(got)
    finally:
        b.close()


# -- the wire against the JAX package's ----------------------------------------

def test_frame_bytes_equal_jax():
    X = rows(5)
    for mod_hdr in ({"kind": "hello"}, {"kind": "stats"},
                    {"kind": "swap", "version": 3, "epoch": 2}):
        assert _wire(ttransport, mod_hdr) == _wire(jtransport, mod_hdr)
    th, tp = ttransport.pack_batch(X)
    jh, jp = jtransport.pack_batch(X)
    assert (th, tp) == (jh, jp)
    hdr = dict(th, kind="dispatch", version=None, budget_s=0.25)
    assert _wire(ttransport, hdr, tp) == _wire(jtransport, hdr, jp)
    np.testing.assert_array_equal(ttransport.unpack_batch(jh, jp), X)
    a, b = socket.socketpair()
    try:
        jtransport.write_frame(a, hdr, jp)
        got, body = ttransport.read_frame(b)
    finally:
        a.close()
        b.close()
    assert got == dict(hdr, schema=jtransport.FRAME_SCHEMA) and body == jp


def _zoo_weights(model, d):
    import jax

    from fedamw_tpu.models import get_model as jget_model

    params = jget_model(model).init(jax.random.PRNGKey(0), d, C)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("model", ["linear", "mlp16", "conv4x8"])
@pytest.mark.parametrize("fused, version", [(False, 0), (True, 7)])
def test_weights_pack_and_fingerprint_equal_jax(model, fused, version):
    jparams = _zoo_weights(model, 64 if model == "conv4x8" else D)
    tparams = params_from_jax(jparams)  # tensors, the JAX key names
    rff = None
    if fused:
        rng = np.random.RandomState(2)
        rff = (rng.randn(8, D).astype(np.float32),
               rng.randn(D).astype(np.float32))
    # the port's engine boundary: tensors to host arrays, then the frame
    hp, hr = ttransport._host_weights(tparams, rff and tuple(
        torch.from_numpy(a) for a in rff))
    assert ttransport.weights_fingerprint(hp, hr, version) == \
        jtransport.weights_fingerprint(jparams, rff, version)
    assert weights_fingerprint(hp, hr, version + 1) != \
        jtransport.weights_fingerprint(jparams, rff, version)
    for blob in (ttransport.pack_weights(hp, hr),
                 jtransport.pack_weights(jparams, rff)):
        for mod in (ttransport, jtransport):
            p, r = mod.unpack_weights(blob)
            assert sorted(p) == sorted(jparams)
            for k in p:
                np.testing.assert_array_equal(p[k], jparams[k])
            assert (r is None) == (rff is None)


@pytest.mark.parametrize("case", ["truncated", "magic", "oversized",
                                  "header", "schema", "batch", "weights"])
def test_malformed_frames_raise_the_jax_type_and_message(case):
    def run(mod):
        if case == "batch":
            return mod.unpack_batch({"rows": 2, "cols": 3,
                                     "dtype": "float32"}, b"\x00" * 7)
        if case == "weights":
            return mod.unpack_weights(b"not an npz")
        a, b = socket.socketpair()
        try:
            hdr = mod._PREFIX.pack(mod.FRAME_MAGIC, 9, 0)
            raw = {"truncated": hdr + b'{"sch',
                   "magic": b"NOT A FRAME AT ALL PADPADPAD",
                   "oversized": mod._PREFIX.pack(mod.FRAME_MAGIC,
                                                 1 << 30, 0),
                   "header": hdr + b"not json!",
                   "schema": mod._PREFIX.pack(mod.FRAME_MAGIC, 13, 0)
                   + b'{"schema": 1}'}[case]
            a.sendall(raw)
            a.close()
            return mod.read_frame(b)
        finally:
            b.close()

    with pytest.raises(jtransport.FrameError) as ej:
        run(jtransport)
    with pytest.raises(FrameError) as et:
        run(ttransport)
    assert str(et.value) == str(ej.value)


# -- a worker in this process over the port's engine ---------------------------

def _engine(buckets=BUCKETS, seed=1):
    e = ServingEngine(_params(seed), buckets=buckets, device="cpu")
    e.warmup()
    return e


def test_in_process_worker_dispatch_sync_and_tensor_announce():
    engine = _engine()
    with PodWorker(engine) as w:
        ep = ("127.0.0.1", w.port)
        with SocketTransport(ep) as t:
            for n in (1, 3, 8, 20):
                X = rows(n, seed=n)
                np.testing.assert_array_equal(t.dispatch(X),
                                              engine.predict(X))
            np.testing.assert_array_equal(t.dispatch(rows(1)[0]),
                                          engine.predict(rows(1)[0]))
        pod = PodClientEngine([ep])
        # a sync reply serves the engine's tensors as host arrays, under
        # the fingerprint the JAX package computes for them
        resp, blob = pod.control(ep, {"kind": "sync"})
        params, rff = ttransport.unpack_weights(blob)
        assert rff is None
        np.testing.assert_array_equal(params["w"], _params()["w"])
        assert resp["fingerprint"] == jtransport.weights_fingerprint(
            _params(), None, 0)
        # an announce of tensors crosses to numpy at the client facade
        new = {"w": torch.from_numpy(_params(seed=4)["w"])}
        assert pod.swap_weights(new) == 1
        assert engine.version == 1
        np.testing.assert_array_equal(engine.params["w"].numpy(),
                                      _params(seed=4)["w"])
    assert w.dispatches == 5 and w.frame_errors == 0


def test_dead_endpoint_fast_fails_inside_its_backoff():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        dead = probe.getsockname()[1]
    t = SocketTransport(("127.0.0.1", dead), backoff_ms=500.0)
    with pytest.raises(TransportRefused, match="connect to worker"):
        t.dispatch(rows(1))
    t0 = time.perf_counter()
    with pytest.raises(TransportRefused, match="reconnect backoff"):
        t.dispatch(rows(1))
    assert time.perf_counter() - t0 < 0.25  # no connect attempt
    assert t.stats()["connect_failures"] == 1


# -- two spawned workers from one exported ladder -----------------------------

def _spawn_workers(tmp, n, device):
    """Export one ladder, start ``n`` ``worker_main`` processes on it in
    fresh interpreters, wait for their ports. Returns (engine, procs,
    endpoints, checkpoint)."""
    ckpt = os.path.join(tmp, "ckpt")
    save_checkpoint(ckpt, _params(), round_idx=1)
    engine = ServingEngine.load(ckpt, buckets=BUCKETS, device=device)
    engine.warmup()
    art = os.path.join(tmp, "art")
    export_ladder(engine, art)
    ctx = multiprocessing.get_context("spawn")
    procs, files = [], []
    for i in range(n):
        files.append(os.path.join(tmp, f"port{i}"))
        p = ctx.Process(target=worker_main, args=(files[-1],),
                        kwargs=dict(artifact_dir=art, checkpoint=ckpt,
                                    worker_id=i, device=device),
                        daemon=True)
        p.start()
        procs.append(p)
    deadline = time.perf_counter() + 120
    while not all(os.path.exists(f) for f in files):
        assert all(p.is_alive() for p in procs), "a worker died at start"
        assert time.perf_counter() < deadline, "workers never came up"
        time.sleep(0.05)
    eps = []
    for f in files:
        with open(f) as fh:
            eps.append(("127.0.0.1", int(fh.read().strip())))
    return engine, procs, eps, ckpt


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(timeout=30)


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    state = _spawn_workers(str(tmp_path_factory.mktemp("pod")), 2, "cpu")
    yield state
    _stop(state[1])


def test_spawned_workers_answer_bitwise_the_in_process_predict(pod):
    engine, procs, eps, _ = pod
    client = PodClientEngine(eps)
    assert client.buckets == BUCKETS and client.input_dim == D
    for ep in eps:
        with SocketTransport(ep) as t:
            for n in (1, 5, 8, 20, 32, 40):
                X = rows(n, seed=n)
                np.testing.assert_array_equal(t.dispatch(X),
                                              engine.predict(X))
    stats = client.worker_stats()
    assert [s["compile_count"] for s in stats] == [0, 0]
    assert {s["pid"] for s in stats} == {p.pid for p in procs}
    assert os.getpid() not in {s["pid"] for s in stats}


def test_swap_announce_lands_both_spawned_workers_on_one_version(pod):
    engine, _, eps, _ = pod
    client = PodClientEngine(eps)
    new = _params(seed=9)
    v = client.swap_weights(new)
    assert v == 1 and client.last_announce["acks"] == 2
    assert [s["version"] for s in client.worker_stats()] == [1, 1]
    engine.swap_weights(new, version=1)
    X = rows(7, seed=3)
    for ep in eps:
        with SocketTransport(ep, client=client) as t:
            np.testing.assert_array_equal(t.dispatch(X), engine.predict(X))
            assert client.pop_timings()["version"] == 1
    assert [s["compile_count"] for s in client.worker_stats()] == [0, 0]


def test_sigkill_mid_batch_requeues_within_deadline(pod):
    """Worker 0 is SIGKILLed as its second batch goes out (the
    transport's scripted kill, then the dispatch into the corpse): the
    batch fails transiently and requeues to worker 1 within its
    deadline; the dead endpoint then fast-fails."""
    engine, procs, eps, _ = pod
    client = PodClientEngine(eps)

    def kill(host):
        os.kill(procs[host].pid, signal.SIGKILL)
        procs[host].join(timeout=30)

    plan = NetChaosPlan.scripted(2, kills={0: 1})
    victim = SocketTransport(eps[0], client=client, host_index=0,
                             chaos=plan, kill_cb=kill, backoff_ms=500.0)
    reps = [Replica(0, client, transport=victim),
            Replica(1, client, transport=SocketTransport(
                eps[1], client=client, host_index=1))]
    with FailoverRouter(reps, policy="round_robin") as router:
        outs = []
        t0 = time.perf_counter()
        for k in range(4):
            X = rows(3 + k, seed=20 + k)
            outs.append((X, router.predict(
                X, deadline=time.perf_counter() + 10.0)))
        took = time.perf_counter() - t0
        stats = router.replica_stats()
    assert took < 10.0
    for X, out in outs:
        np.testing.assert_array_equal(out, engine.predict(X))
    assert procs[0].exitcode == -signal.SIGKILL
    assert victim.faults_injected["kill"] == 1
    assert stats["requeues"] >= 1 and stats["replicas"]["0"]["failed"] >= 1
    assert stats["replicas"]["1"]["ok"] == 3
    with pytest.raises((TransportError, FrameError)):
        victim.dispatch(rows(1))


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_spawned_worker_on_the_card(tmp_path):
    """A worker spawned on the card from an exported ladder answers
    bitwise the in-process engine on the card, with ``compile_count``
    0 and its own process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    engine, procs, eps, _ = _spawn_workers(str(tmp_path), 1, None)
    try:
        client = PodClientEngine(eps)
        with SocketTransport(eps[0]) as t:
            for n in (1, 5, 8, 20, 32, 40):
                X = rows(n, seed=n)
                np.testing.assert_array_equal(t.dispatch(X),
                                              engine.predict(X))
        (stats,) = client.worker_stats()
        assert stats["compile_count"] == 0
        assert stats["pid"] == procs[0].pid != os.getpid()
    finally:
        _stop(procs)
