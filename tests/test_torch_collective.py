"""Parity: ray_tpu_torch.util.collective against tests/test_collective.py's
three cases (:11 the collective ops, :58 a symmetric send/recv, :82 an
allreduce of a pytree), on 2 and on 4 gloo ranks of
tests/torch_dp_worker.py, checked against numpy. The reducescatter input
has 3 rows on 2 ranks and 6 on 4, so that np.array_split's parts are
uneven (2 + 1; 2 + 2 + 1 + 1), which reduce_scatter_tensor alone cannot
split. The point-to-point links each rank made are recorded before and
after its sends (util/collective.py makes them at first use)."""

import numpy as np
import pytest

from test_torch_strategies import launch

WORLDS = [2, 4]
RS_ROWS = {2: 3, 4: 6}


@pytest.fixture(scope="module", params=WORLDS, ids=[f"world{w}" for w in
                                                    WORLDS])
def ranks(request, tmp_path_factory):
    world = request.param
    run = dict(kind="collective", tag="", backend="gloo",
               rs_rows=RS_ROWS[world])
    return world, launch(tmp_path_factory.mktemp(f"col{world}"), [run], {},
                         world=world)


def expected(world):
    """numpy's answers for the worker's collective run."""
    xs = [np.full((4,), float(r + 1)) for r in range(world)]
    rs_in = np.arange(RS_ROWS[world] * 2, dtype=np.float64).reshape(-1, 2)
    return dict(
        allreduce=sum(xs), max=np.maximum.reduce(xs),
        bcast=np.arange(3.0),
        allgather=np.concatenate([np.arange(r + 1) for r in range(world)]),
        rs=np.array_split(rs_in * world, world),
        reduce=sum(xs), recv=np.array([42.0]),
        tree_w=np.ones((2, 2)) * sum(range(1, world + 1)),
        tree_b0=np.ones(2) * sum(range(1, world + 1)),
        tree_b1=np.ones(3) * sum(range(world)))


@pytest.mark.timeout(120)
def test_collective_ops(ranks):
    world, outs = ranks
    want = expected(world)
    for r, out in enumerate(outs):
        for key in ("allreduce", "max", "bcast", "allgather"):
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)
        np.testing.assert_array_equal(out["rs"], want["rs"][r])
        assert out["rs"].dtype == np.float64
        # reduce: the result on dst_rank, the input elsewhere.
        np.testing.assert_array_equal(
            out["reduce"], want["reduce"] if r == world - 1
            else np.full((4,), float(r + 1)))
    np.testing.assert_array_equal(outs[1]["recv"], want["recv"])


@pytest.mark.timeout(120)
def test_symmetric_send_recv(ranks):
    world, outs = ranks
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["sym"], np.array([float(r ^ 1)]))


@pytest.mark.timeout(120)
def test_pair_links_made_only_for_sends(ranks):
    """A group that has only run collectives (allreduce, broadcast,
    allgather, reducescatter, reduce, barrier) has made no point-to-point
    link; after rank 0's send to rank 1 and the partners' exchange
    (rank ^ 1), each rank has made exactly the links it used: both
    directions with its partner."""
    world, outs = ranks
    for r, out in enumerate(outs):
        assert out["links_before_p2p"].shape == (0, 2), r
        pair = sorted([(r, r ^ 1), (r ^ 1, r)])
        assert [tuple(x) for x in out["links"]] == pair, r


@pytest.mark.timeout(120)
def test_allreduce_pytree(ranks):
    world, outs = ranks
    want = expected(world)
    for out in outs:
        for key in ("tree_w", "tree_b0", "tree_b1"):
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)
