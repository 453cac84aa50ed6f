"""Parity: ray_tpu_torch.util.collective's groups between ray_tpu actors
against ray_tpu.util.collective's, the same calls through both packages.

JAX's three cases (tests/test_collective.py :11 the collective ops, :58 a
symmetric send/recv, :82 an allreduce of a pytree) run on actors joined by
each package's create_collective_group, the port's actors with the port's
CollectiveGroupMixin and JAX's with JAX's, on inputs drawn from
np.random.default_rng(0) in this process and handed to both. Then one set
of actors in two groups at once ("a": 2 members; "b": 3, ranks permuted)
with their ops interleaved, the rank queries before, during and after
destroy_collective_group, one name formed again by other members and
another size (through create_collective_group, and over a default world
the actors share), the error cases with JAX's messages, and a group of one
over util/local_runtime.py (runtime=None) in this process.

Float64 results are held within 1e-12 relative of JAX's (the sums may
associate differently across three members); integer, broadcast, gather,
send and receive results must equal JAX's exactly, dtype included.
"""

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _member_class(ray_tpu, pkg):
    """A ray_tpu actor class with ``pkg``'s mixin whose ``run`` calls
    ``pkg.util.collective``'s functions in order and returns, per call,
    ("ok", value) or ("error", exception type, message). Defined in a
    function so that ray_tpu ships it by value; it imports the package in
    its methods."""
    import importlib
    col = importlib.import_module(f"{pkg}.util.collective")

    @ray_tpu.remote
    class Member(col.CollectiveGroupMixin):
        def __init__(self, pkg):
            self.pkg = pkg

        def serve_world(self):
            """As rank 0 of a default torch.distributed world: serve its
            store on a port the bind picks. -> the port."""
            import datetime

            import torch.distributed as dist
            self.world = dist.TCPStore(
                "127.0.0.1", 0, is_master=True, wait_for_workers=False,
                timeout=datetime.timedelta(seconds=60))
            return self.world.port

        def join_world(self, port, rank, size):
            """Join the default gloo world whose rank 0 serves ``port``."""
            import datetime

            import torch.distributed as dist
            timeout = datetime.timedelta(seconds=60)
            store = self.world if rank == 0 else dist.TCPStore(
                "127.0.0.1", port, is_master=False, timeout=timeout)
            dist.init_process_group("gloo", store=store, rank=rank,
                                    world_size=size, timeout=timeout)
            return dist.get_rank()

        def run(self, calls):
            import importlib
            col = importlib.import_module(f"{self.pkg}.util.collective")
            out = []
            for name, args, kwargs in calls:
                try:
                    out.append(("ok", getattr(col, name)(*args, **kwargs)))
                except Exception as e:   # compared with the other package
                    out.append(("error", type(e).__name__, str(e)))
            return out

    return Member


def _create(ray_tpu, pkg, actors, world, ranks, name):
    import importlib
    col = importlib.import_module(f"{pkg}.util.collective")
    if pkg == "ray_tpu":
        col.create_collective_group(actors, world, ranks, group_name=name)
    else:
        col.create_collective_group(actors, world, ranks, group_name=name,
                                    runtime=ray_tpu)


def _run(ray_tpu, actors, scripts, timeout=120):
    return ray_tpu.get([a.run.remote(s) for a, s in zip(actors, scripts)],
                       timeout=timeout)


def _both(ray_shared, n_actors, body):
    """``body(pkg, actors)`` for each package on fresh actors; -> {pkg:
    its result}."""
    out = {}
    for pkg in PACKAGES:
        cls = _member_class(ray_shared, pkg)
        actors = [cls.remote(pkg) for _ in range(n_actors)]
        try:
            out[pkg] = body(pkg, actors)
        finally:
            for a in actors:
                ray_shared.kill(a)
    return out


def _same(port, jax_, where=""):
    """The port's value equals JAX's: float64 within 1e-12 relative, the
    rest exactly (trees and lists leaf by leaf)."""
    if isinstance(jax_, dict):
        assert isinstance(port, dict) and port.keys() == jax_.keys(), where
        for k in jax_:
            _same(port[k], jax_[k], f"{where}/{k}")
    elif isinstance(jax_, (list, tuple)):
        assert type(port) is type(jax_) and len(port) == len(jax_), (
            where, port, jax_)
        for i, (p, j) in enumerate(zip(port, jax_)):
            _same(p, j, f"{where}[{i}]")
    elif isinstance(jax_, np.ndarray):
        assert isinstance(port, np.ndarray), (where, type(port))
        assert port.dtype == jax_.dtype and port.shape == jax_.shape, (
            where, port.dtype, jax_.dtype, port.shape, jax_.shape)
        if jax_.dtype == np.float64:
            np.testing.assert_allclose(port, jax_, rtol=1e-12, atol=0,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(port, jax_, err_msg=where)
    else:
        assert port == jax_, (where, port, jax_)


def _same_runs(out, queries=0):
    """Every actor's every call: the same outcome in both packages, each
    call after the first ``queries`` of an actor a success."""
    for r, (port, jax_) in enumerate(zip(out["ray_tpu_torch"],
                                         out["ray_tpu"])):
        assert len(port) == len(jax_)
        failed = [c for c in port[queries:] + jax_[queries:] if c[0] != "ok"]
        assert not failed, (r, failed)
        for i, (p, j) in enumerate(zip(port, jax_)):
            assert p[0] == j[0], (r, i, p, j)
            _same(p[1:], j[1:], f"actor {r}, call {i}")


@pytest.mark.timeout(180)
def test_collective_ops_match_jax(ray_shared):
    """tests/test_collective.py:11 on seeded inputs (plus a reduce and an
    integer allreduce), world 2."""
    rng = np.random.default_rng(0)
    world, g = 2, "ops"
    x = [rng.standard_normal(4) for _ in range(world)]
    ints = [rng.integers(-1000, 1000, size=3) for _ in range(world)]
    b = rng.standard_normal(3)
    rs = [rng.standard_normal((5, 2)) for _ in range(world)]   # parts 3 + 2
    msg = rng.standard_normal(1)

    def script(r):
        calls = [
            ("allreduce", (x[r],), dict(group_name=g)),
            ("allreduce", (ints[r],), dict(group_name=g)),
            ("broadcast", (b if r == 1 else None,),
             dict(src_rank=1, group_name=g)),
            ("allgather", (ints[r][:r + 1],), dict(group_name=g)),
            ("reducescatter", (rs[r],), dict(group_name=g)),
            ("reduce", (x[r],), dict(dst_rank=1, group_name=g)),
            ("barrier", (), dict(group_name=g))]
        if r == 0:
            calls.append(("send", (msg,), dict(dst_rank=1, group_name=g)))
        else:
            calls.append(("recv", (), dict(src_rank=0, group_name=g)))
        return calls

    def body(pkg, actors):
        _create(ray_shared, pkg, actors, world, [0, 1], g)
        return _run(ray_shared, actors, [script(r) for r in range(world)])

    out = _both(ray_shared, world, body)
    _same_runs(out)
    np.testing.assert_array_equal(out["ray_tpu_torch"][1][-1][1], msg)


@pytest.mark.timeout(180)
def test_symmetric_send_recv_matches_jax(ray_shared):
    """tests/test_collective.py:58: each rank sends to its partner, then
    receives."""
    rng = np.random.default_rng(0)
    g = "sym"
    vals = [rng.standard_normal(3) for _ in range(2)]

    def body(pkg, actors):
        _create(ray_shared, pkg, actors, 2, [0, 1], g)
        return _run(ray_shared, actors, [
            [("send", (vals[r],), dict(dst_rank=1 - r, group_name=g)),
             ("recv", (), dict(src_rank=1 - r, group_name=g))]
            for r in range(2)])

    out = _both(ray_shared, 2, body)
    _same_runs(out)
    for r in range(2):
        np.testing.assert_array_equal(out["ray_tpu_torch"][r][1][1],
                                      vals[1 - r])


@pytest.mark.timeout(180)
def test_allreduce_pytree_matches_jax(ray_shared):
    """tests/test_collective.py:82 on seeded leaves (plus an integer
    leaf)."""
    rng = np.random.default_rng(0)
    g = "tree"
    trees = [{"w": rng.standard_normal((2, 2)), "b": rng.standard_normal(2),
              "n": rng.integers(0, 100, size=2)} for _ in range(2)]

    def body(pkg, actors):
        _create(ray_shared, pkg, actors, 2, [0, 1], g)
        return _run(ray_shared, actors, [
            [("allreduce", (trees[r],), dict(group_name=g))]
            for r in range(2)])

    out = _both(ray_shared, 2, body)
    _same_runs(out)


# Ranks of actors 0, 1, 2 in group "a" (world 2; actor 2 not in it) and in
# group "b" (world 3, permuted).
RANKS_A = {0: 0, 1: 1}
RANKS_B = {0: 2, 1: 0, 2: 1}
# The interleaved ops, in one order for every actor; each actor runs those
# of its groups.
PLAN = [("a", "allreduce"), ("b", "allreduce"), ("a", "broadcast"),
        ("b", "allgather"), ("b", "reducescatter"), ("a", "sendrecv"),
        ("b", "broadcast"), ("a", "allgather"), ("b", "ring"),
        ("b", "reduce"), ("a", "allreduce")]


def _queries():
    return [(q, (name,), {}) for name in ("a", "b") for q in (
        "is_group_initialized", "get_rank", "get_collective_group_size")]


def _two_group_scripts(rng):
    """The interleaved calls of each of the three actors, with inputs
    drawn for every (op, group, rank)."""
    scripts = {i: _queries() for i in range(3)}
    for name, op in PLAN:
        ranks = RANKS_A if name == "a" else RANKS_B
        world = len(ranks)
        draws = {r: rng.standard_normal((world + 2, 2)) for r in
                 range(world)}
        for actor, r in ranks.items():
            kw = dict(group_name=name)
            x = draws[r]
            if op == "allreduce":
                calls = [("allreduce", (x,), kw)]
            elif op == "broadcast":
                src = world - 1
                calls = [("broadcast", (x if r == src else None,),
                          dict(kw, src_rank=src))]
            elif op == "allgather":
                calls = [("allgather", (x[:r + 1],), kw)]
            elif op == "reducescatter":
                calls = [("reducescatter", (x,), kw)]
            elif op == "reduce":
                calls = [("reduce", (x,), dict(kw, dst_rank=1))]
            elif op == "sendrecv":     # partners, as :58
                calls = [("send", (x,), dict(kw, dst_rank=1 - r)),
                         ("recv", (), dict(kw, src_rank=1 - r))]
            else:                      # "ring": to the next rank
                calls = [("send", (x,), dict(kw, dst_rank=(r + 1) % world)),
                         ("recv", (), dict(kw, src_rank=(r - 1) % world))]
            scripts[actor] += calls
    return [scripts[i] for i in range(3)]


@pytest.mark.timeout(240)
def test_two_groups_match_jax(ray_shared):
    """One set of three actors in group "a" (actors 0, 1 as ranks 0, 1)
    and group "b" (actors 1, 2, 0 as ranks 0, 1, 2) at once, their ops
    interleaved; the rank queries before the groups, while both stand,
    after "a" is destroyed (then "b" still works) and after "b" is."""
    rng = np.random.default_rng(0)
    during = _two_group_scripts(rng)
    after_a = [rng.standard_normal(3) for _ in range(3)]

    def body(pkg, actors):
        res = {"before": _run(ray_shared, actors, [_queries()] * 3)}
        a_ranks = sorted(RANKS_A, key=RANKS_A.get)
        b_ranks = sorted(RANKS_B, key=RANKS_B.get)
        _create(ray_shared, pkg, [actors[i] for i in a_ranks], 2, [0, 1],
                "a")
        _create(ray_shared, pkg, [actors[i] for i in b_ranks], 3,
                [0, 1, 2], "b")
        res["during"] = _run(ray_shared, actors, during)
        res["after_a"] = _run(ray_shared, actors, [
            [("destroy_collective_group", ("a",), {}) if i in RANKS_A
             else ("is_group_initialized", ("a",), {})] + _queries()
            + [("allreduce", (after_a[i],), dict(group_name="b")),
               ("broadcast", (after_a[i] if RANKS_B[i] == 0 else None,),
                dict(src_rank=0, group_name="b"))]
            for i in range(3)])
        res["after_b"] = _run(ray_shared, actors, [
            [("destroy_collective_group", ("b",), {})] + _queries()
            for _ in range(3)])
        return res

    out = _both(ray_shared, 3, body)
    for phase, queries in (("before", 6), ("during", 6), ("after_a", 7),
                           ("after_b", 7)):
        _same_runs({pkg: out[pkg][phase] for pkg in PACKAGES}, queries)
    port = out["ray_tpu_torch"]
    # The queries themselves: ranks and sizes per group, errors elsewhere.
    for i in range(3):
        assert port["before"][i][0] == ("ok", False)
        q = port["during"][i][:6]
        assert q[0] == ("ok", i in RANKS_A) and q[3] == ("ok", True)
        if i in RANKS_A:
            assert q[1:3] == [("ok", RANKS_A[i]), ("ok", 2)]
        else:
            assert q[1][0] == "error" and "'a' not initialized" in q[1][2]
        assert q[4:6] == [("ok", RANKS_B[i]), ("ok", 3)]
        after_a_q = port["after_a"][i][1:7]
        assert after_a_q[0] == ("ok", False)
        assert after_a_q[3:] == [("ok", True), ("ok", RANKS_B[i]), ("ok", 3)]
        assert port["after_b"][i][4] == ("ok", False)


# Group "a" formed three times on three actors, destroyed between: {actor:
# rank}. The second forming puts actor 2 in actor 1's place, the third
# changes the size; each member has its own history of the name.
FORMINGS = [{0: 0, 1: 1}, {0: 0, 2: 1}, {2: 0, 0: 1, 1: 2}]


def _forming_scripts(rng, ranks):
    """Each actor's calls in one forming of "a" (none for a non-member):
    an allreduce, a broadcast from the last rank, an allgather, a ring
    send/recv and the queries; then, once every member is done (JAX's
    rank 0 kills the group's rendezvous), destroy_collective_group."""
    world, kw = len(ranks), dict(group_name="a")
    draws = {r: rng.standard_normal(3) for r in range(world)}
    scripts = [[] for _ in range(3)]
    for actor, r in ranks.items():
        x = draws[r]
        scripts[actor] = [
            ("allreduce", (x,), kw),
            ("broadcast", (x if r == world - 1 else None,),
             dict(kw, src_rank=world - 1)),
            ("allgather", (x[:r + 1],), kw),
            ("send", (x,), dict(kw, dst_rank=(r + 1) % world)),
            ("recv", (), dict(kw, src_rank=(r - 1) % world)),
            ("get_rank", ("a",), {}), ("get_collective_group_size", ("a",), {})]
    return scripts, [[("destroy_collective_group", ("a",), {}),
                      ("is_group_initialized", ("a",), {})] if calls else []
                     for calls in scripts]


@pytest.mark.timeout(240)
@pytest.mark.parametrize("route", ["create", "world"])
def test_group_formed_again_by_other_members_matches_jax(ray_shared, route):
    """One name formed, destroyed and formed again by other members
    (FORMINGS), each member with its own history of the name, against
    JAX's create_collective_group on the same calls. ``route``: the port's
    groups through create_collective_group (a store of the forming's own),
    or by init_collective_group with no init_method on actors that share a
    default gloo world (its store outlives each forming)."""
    rng = np.random.default_rng(0)
    scripts = [_forming_scripts(rng, ranks) for ranks in FORMINGS]

    def body(pkg, actors):
        if pkg == "ray_tpu_torch" and route == "world":
            port = ray_shared.get(actors[0].serve_world.remote(), timeout=60)
            assert ray_shared.get([a.join_world.remote(port, i, 3) for i, a
                                   in enumerate(actors)], timeout=120) == [
                0, 1, 2]
        out = []
        for ranks, (script, leave) in zip(FORMINGS, scripts):
            if pkg == "ray_tpu" or route == "create":
                by_rank = sorted(ranks, key=ranks.get)
                _create(ray_shared, pkg, [actors[i] for i in by_rank],
                        len(ranks), list(range(len(ranks))), "a")
            else:
                script = [[("init_collective_group", (len(ranks), ranks[i]),
                            dict(group_name="a"))] + calls if calls else []
                          for i, calls in enumerate(script)]
            got = _run(ray_shared, actors, script)
            if pkg == "ray_tpu_torch" and route == "world":
                assert all(c[:1] == [("ok", None)] for c in got if c), got
                got = [c[1:] for c in got]
            out.append([c + d for c, d in
                        zip(got, _run(ray_shared, actors, leave))])
        return out

    out = _both(ray_shared, 3, body)
    for i, ranks in enumerate(FORMINGS):
        _same_runs({pkg: out[pkg][i] for pkg in PACKAGES})
        for actor, r in ranks.items():
            assert out["ray_tpu_torch"][i][actor][5:7] == [
                ("ok", r), ("ok", len(ranks))]


@pytest.mark.timeout(120)
def test_errors_match_jax(ray_shared):
    """JAX's checks and messages: a rank out of range, an op or a query on
    a group not initialized here (in this process), a name initialized
    twice in one actor; and the port's own: a group of more than one with
    no runtime, ranks that are not the world's, a rank 0 that serves no
    store for its tcp:// address, an address that is not tcp://."""
    import ray_tpu.util.collective as jcol

    import ray_tpu_torch.util.collective as pcol

    def outcome(fn, *args, **kwargs):
        try:
            return ("ok", fn(*args, **kwargs))
        except Exception as e:
            return ("error", type(e).__name__, str(e))

    x = np.random.default_rng(0).standard_normal(2)
    cases = [("init_collective_group", (2, 2), {}),
             ("init_collective_group", (3, -1), {}),
             ("allreduce", (x,), dict(group_name="nope")),
             ("broadcast", (x,), dict(group_name="nope")),
             ("barrier", (), dict(group_name="nope")),
             ("send", (x, 1), dict(group_name="nope")),
             ("recv", (1,), dict(group_name="nope")),
             ("get_rank", ("nope",), {}),
             ("get_collective_group_size", ("nope",), {}),
             ("is_group_initialized", ("nope",), {}),
             ("destroy_collective_group", ("nope",), {})]
    for name, args, kwargs in cases:
        got = outcome(getattr(pcol, name), *args, **kwargs)
        want = outcome(getattr(jcol, name), *args, **kwargs)
        assert got == want, (name, got, want)

    def twice(pkg, actors):
        _create(ray_shared, pkg, actors, 1, [0], "twice")
        with pytest.raises(Exception) as err:
            _create(ray_shared, pkg, actors, 1, [0], "twice")
        ray_shared.get(actors[0].run.remote(
            [("destroy_collective_group", ("twice",), {})]), timeout=60)
        return str(err.value)

    out = _both(ray_shared, 1, twice)
    for pkg in PACKAGES:
        assert "group 'twice' already initialized here" in out[pkg], out

    from ray_tpu_torch.util import local_runtime
    local = [local_runtime.remote(pcol.CollectiveGroupMixin).remote()
             for _ in range(2)]
    with pytest.raises(ValueError, match="needs a runtime"):
        pcol.create_collective_group(local, 2, [0, 1])
    with pytest.raises(ValueError, match="every rank of a world of 2"):
        pcol.create_collective_group(local, 2, [0, 0], runtime=ray_shared)
    with pytest.raises(ValueError, match="open_collective_store before"):
        pcol.init_collective_group(2, 0, group_name="x",
                                   init_method="tcp://127.0.0.1:1")
    with pytest.raises(ValueError, match="tcp://host:port"):
        pcol.init_collective_group(2, 1, group_name="x",
                                   init_method="file:///x")
    with pytest.raises(ValueError, match="backend 'xla'"):
        pcol.init_collective_group(1, 0, backend="xla", group_name="x")
    assert not pcol.is_group_initialized("x")


@pytest.mark.timeout(120)
def test_group_of_one_in_process_matches_jax(ray_shared):
    """runtime=None: util/local_runtime.py actors in this process, a group
    of one (a store of its own), against JAX's group of one on an actor:
    every op of the three cases, a send to itself then its recv."""
    from ray_tpu_torch.util import collective as pcol
    from ray_tpu_torch.util import local_runtime
    rng = np.random.default_rng(0)
    g = "solo"
    tree = {"w": rng.standard_normal((2, 3)), "b": [rng.standard_normal(2),
                                                    rng.integers(0, 9, 4)]}
    x = rng.standard_normal(4)
    calls = [("allreduce", (tree,), dict(group_name=g)),
             ("reduce", (x,), dict(group_name=g)),
             ("broadcast", (tree,), dict(group_name=g)),
             ("allgather", (x,), dict(group_name=g)),
             ("reducescatter", (x,), dict(group_name=g)),
             ("barrier", (), dict(group_name=g)),
             ("send", (x,), dict(dst_rank=0, group_name=g)),
             ("send", (2 * x,), dict(dst_rank=0, group_name=g)),
             ("recv", (), dict(src_rank=0, group_name=g)),
             ("recv", (), dict(src_rank=0, group_name=g)),
             ("get_rank", (g,), {}), ("get_collective_group_size", (g,), {}),
             ("destroy_collective_group", (g,), {}),
             ("is_group_initialized", (g,), {})]

    def jax_body(pkg, actors):
        _create(ray_shared, pkg, actors, 1, [0], g)
        return _run(ray_shared, actors, [calls])[0]

    cls = _member_class(ray_shared, "ray_tpu")
    actor = cls.remote("ray_tpu")
    try:
        want = jax_body("ray_tpu", [actor])
    finally:
        ray_shared.kill(actor)

    class Local(pcol.CollectiveGroupMixin):
        def run(self, calls):
            out = []
            for name, args, kwargs in calls:
                out.append(("ok", getattr(pcol, name)(*args, **kwargs)))
            return out

    member = local_runtime.remote(Local).remote()
    pcol.create_collective_group([member], 1, [0], group_name=g)
    got = local_runtime.get(member.run.remote(calls))
    _same_runs({"ray_tpu_torch": [got], "ray_tpu": [want]})
