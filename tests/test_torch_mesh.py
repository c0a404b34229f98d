"""The port's ``parallel/mesh.py`` against the JAX package's, on the CPU and
in one process.

``shard_setup``'s blocks against the JAX package's placement on its
2-device virtual mesh (the rows device ``r`` holds are rank ``r``'s), flat
and bucketed; its refusal of an uneven client axis, ``make_mesh``'s
errors and ``validate_cohort_alignment``'s message word for word;
``prepare_setup(client_multiple=N)``'s padding array for array (identity
features, so both packages map nothing); ``ClientAxis``'s blocks, its
``gather`` and the row-sliced shuffle draw against the whole ones. A
setup on the one-rank mesh of a process with no group
(``make_mesh()``) runs the sharded code path with identity collectives
and must equal the flat run bit for bit; a sharded setup refuses
``sequential`` and a misaligned ``cohort_shards`` (in-graph or
streamed) before any round. The spawned groups are
``tests/test_torch_ranks.py`` and ``tests/test_torch_ranks_driver.py``.
"""

import functools

import numpy as np
import pytest
import torch

import fedamw_tpu.algorithms as J
from fedamw_tpu.data import load_dataset as jload_dataset
from fedamw_tpu.parallel import make_mesh as jmake_mesh
from fedamw_tpu.parallel import shard_setup as jshard_setup
from fedamw_tpu.parallel import (
    validate_cohort_alignment as jvalidate_cohort_alignment)
import fedamw_tpu_torch.algorithms as T
from fedamw_tpu_torch.data import load_dataset
from fedamw_tpu_torch.fedcore.batching import draw_epoch_positions
from fedamw_tpu_torch.parallel import (
    ClientAxis,
    ClientMesh,
    client_spec,
    make_mesh,
    replicated,
    shard_client_keys,
    shard_setup,
    validate_cohort_alignment,
)

CPU = torch.device("cpu")


def _fake(rank, size=2):
    """Rank ``rank`` of ``size`` with no process group: the placement
    without the collectives."""
    return ClientMesh(size, rank, CPU, False)


@functools.lru_cache(maxsize=None)
def _setups(J_, buckets, multiple):
    """The JAX package's and the port's setups of digits, identity
    features (no RFF draw to differ)."""
    common = dict(kernel_type="linear", seed=1, buckets=buckets,
                  client_multiple=multiple)
    sj = J.prepare_setup(jload_dataset("digits", num_partitions=J_,
                                       alpha=0.5),
                         rng=np.random.RandomState(1), **common)
    st = T.prepare_setup(load_dataset("digits", num_partitions=J_,
                                      alpha=0.5),
                         rng=np.random.RandomState(1), device="cpu", **common)
    return sj, st


def _device_block(a, r):
    """The rows of a JAX array that device ``r`` of its mesh holds."""
    shard = sorted(a.addressable_shards, key=lambda s: s.device.id)[r]
    return np.asarray(shard.data)


@pytest.mark.parametrize("buckets", [1, 3])
@pytest.mark.parametrize("multiple", [1, 4])
def test_client_multiple_pads_as_jax(buckets, multiple):
    sj, st = _setups(10, buckets, multiple)
    for a, b in zip(sj.round_arrays(), st.round_arrays()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
            assert y.shape[0] % multiple == 0
    np.testing.assert_array_equal(st.sizes.numpy(), np.asarray(sj.sizes))
    np.testing.assert_array_equal(st.p_fixed.numpy(),
                                  np.asarray(sj.p_fixed))


@pytest.mark.parametrize("buckets", [1, 3])
@pytest.mark.parametrize("rank", [0, 1])
def test_shard_setup_blocks_match_jax(buckets, rank):
    sj, st = _setups(10, buckets, 2)
    placed = jshard_setup(sj, jmake_mesh(2))
    mine = shard_setup(st, _fake(rank))
    assert mine.mesh_devices == placed.mesh_devices == 2
    for a, b in zip(placed.round_arrays(), mine.round_arrays()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), _device_block(x, rank))
    # everything else whole
    for k in ("X", "y", "X_val", "y_val", "X_test", "sizes", "p_fixed"):
        assert torch.equal(getattr(mine, k), getattr(st, k)), k
    assert mine.num_clients == st.num_clients


@pytest.mark.parametrize("buckets,J_", [(1, 5), (3, 10)])
def test_shard_setup_refuses_an_uneven_axis_as_jax(buckets, J_):
    sj, st = _setups(J_, buckets, 1)
    msgs = []
    for fn in (lambda: jshard_setup(sj, jmake_mesh(2)),
               lambda: shard_setup(st, _fake(0))):
        with pytest.raises(ValueError) as err:
            fn()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "client_multiple=2" in msgs[1]


@pytest.mark.parametrize("shards,devices", [(4, 2), (3, 2), (5, 1), (6, 4),
                                            (8, 8)])
def test_validate_cohort_alignment_matches_jax(shards, devices):
    outcome = []
    for fn in (jvalidate_cohort_alignment, validate_cohort_alignment):
        try:
            outcome.append(fn(shards, devices))
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]


def test_make_mesh_without_a_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.grouped, mesh.device) == (1, 0, False,
                                                                 CPU)
    assert make_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError) as mine:
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jmake_mesh(9)
    assert str(mine.value) == "requested 2 devices, have 1"
    assert str(theirs.value) == "requested 9 devices, have 8"
    # identity collectives
    t = torch.arange(3.0)
    assert mesh.all_reduce(t) is t and mesh.all_gather(t) is t


def test_client_spec_shard_client_keys_and_replicated():
    keys = np.arange(8 * 3).reshape(8, 3)
    for r in range(4):
        mesh = _fake(r, 4)
        assert client_spec(mesh, 8) == slice(2 * r, 2 * r + 2)
        np.testing.assert_array_equal(shard_client_keys(keys, mesh),
                                      keys[2 * r:2 * r + 2])
        assert replicated(mesh, 8) == slice(0, 8)


class _Gathered:
    """A stand-in for two ranks' ``all_gather``: the given per-rank
    tensors concatenated."""

    def __init__(self, parts):
        self.parts, self.size = parts, len(parts)

    def all_gather(self, t, dim=0):
        return torch.cat(self.parts, dim)


def test_client_axis_local_and_gather_in_bucket_order():
    """Each rank holds its block of every bucket; gathering the blocks
    puts every client back in the bucket-major order, on any axis."""
    _, st = _setups(10, 3, 2)
    Jn = st.num_clients
    axes = [ClientAxis(shard_setup(st, _fake(r))) for r in range(2)]
    v = torch.arange(Jn)
    logits = torch.randn(5, Jn, 3)
    counts = st.bucket_counts
    offs = np.cumsum((0,) + counts)
    for r, ax in enumerate(axes):
        want = torch.cat([v[offs[g] + r * c // 2:offs[g] + (r + 1) * c // 2]
                          for g, c in enumerate(counts)])
        assert torch.equal(ax.local(v), want)
        assert ax.blocks == tuple((r * c // 2, (r + 1) * c // 2, c)
                                  for c in counts)
    for x, dim in ((v, 0), (logits, 1)):
        parts = [ax.local(x.transpose(0, dim)).transpose(0, dim)
                 for ax in axes]
        axes[0].mesh = _Gathered(parts)
        assert torch.equal(axes[0].gather(parts[0], dim), x)
    flat = ClientAxis(st)
    assert not flat.sharded and flat.blocks is None
    assert flat.local(v) is v and flat.gather(v) is v


@pytest.mark.parametrize("rows", [slice(0, 3), slice(3, 6), slice(2, 5)])
def test_a_row_sliced_draw_is_the_whole_draws_rows(rows):
    mask = (torch.rand(6, 11, generator=torch.Generator().manual_seed(0))
            > 0.3).float()
    whole = draw_epoch_positions(torch.Generator().manual_seed(5), 11, 4,
                                 mask, lead=(6,))
    part = draw_epoch_positions(torch.Generator().manual_seed(5), 11, 4,
                                mask[rows], lead=(6,), rows=rows)
    assert torch.equal(part, whole[rows])


KW = dict(lr=0.5, epoch=2, round=3, seed=0, lr_mode="constant",
          return_state=True)


@pytest.mark.parametrize("algo,extra", [
    ("FedAvg", {}),
    ("FedAMW", {"faults": "drop=0.2,corrupt=0.2:nan,seed=3",
                "robust_agg": "quarantine:auto+rep:0.5:0.2"}),
    ("FedNova", {"cohort_shards": 2, "participation": 0.5}),
    ("FedAvg", {"faults": "corrupt=0.3:sign,seed=4", "robust_agg": "krum"}),
])
def test_the_one_rank_mesh_is_the_flat_run(algo, extra):
    _, st = _setups(6, 1, 1)
    mine = shard_setup(st, make_mesh(device="cpu"))
    a = getattr(T, algo)(st, **KW, **extra)
    b = getattr(T, algo)(mine, **KW, **extra)
    for k in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert torch.equal(b["params"]["w"], a["params"]["w"])
    assert torch.equal(b["p"], a["p"])


@pytest.mark.parametrize("opts,match", [
    ({"sequential": True}, "sequential=True cannot run over"),
    ({"stream_cohort": True, "cohort_shards": 3},
     "does not align with the 2-device"),
    ({"cohort_shards": 3}, "does not align with the 2-device"),
])
def test_a_sharded_setup_refuses(opts, match):
    _, st = _setups(10, 1, 2)
    mine = shard_setup(st, _fake(0))
    with pytest.raises(ValueError, match=match):
        T.FedAvg(mine, **KW, **opts)
