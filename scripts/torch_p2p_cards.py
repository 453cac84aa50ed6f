"""Point to point between NCCL collective groups on four cards, with a time limit.

    python scripts/torch_p2p_cards.py

Four processes, one card each, meet in a gloo default world and form
``util.collective`` groups over it: "all" (NCCL, world 4) and "half" (NCCL,
cards 3 and 2 as ranks 0 and 1). They run the exchanges of
``tests/test_torch_cuda.py::test_collective_groups_of_actors_across_cards``
(rank 0 to 1, partners, a ring, then the pair of "half") and a tree
allreduce, checking each value, and do it twice (the names formed again).
Each rank prints its group set-up ms and card bytes, its first exchanges'
ms and card bytes (the first collectives' buffers included), and the links
it made. A rank that does not finish within 150 s dumps every thread's
stack and exits, so that a hang shows where it stands and ends the run.
"""

import faulthandler
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

WORLD, PORT, LIMIT_S = 4, 29533, 150
HALF_RANK = {3: 0, 2: 1}


def _used(dev) -> int:
    free, total = torch.cuda.mem_get_info(dev)
    return total - free


def _rank(rank: int) -> None:
    faulthandler.dump_traceback_later(LIMIT_S, exit=True)
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                            world_size=WORLD, rank=rank)
    from ray_tpu_torch.util import collective as col
    for forming in range(2):
        m0, t0 = _used(dev), time.perf_counter()
        col.init_collective_group(WORLD, rank, backend="nccl",
                                  group_name="all")
        if rank in HALF_RANK:
            col.init_collective_group(2, HALF_RANK[rank], backend="nccl",
                                      group_name="half")
        make_ms, m1 = 1e3 * (time.perf_counter() - t0), _used(dev)
        x = torch.full((4,), float(rank), device=dev)
        col.allreduce(x, group_name="all")
        col.barrier(group_name="all")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if rank == 0:
            col.send(x, dst_rank=1, group_name="all")
        elif rank == 1:
            assert float(col.recv(src_rank=0, group_name="all")[0]) == 0.0
        col.send(x + 10, dst_rank=rank ^ 1, group_name="all")
        got = col.recv(src_rank=rank ^ 1, group_name="all")
        assert float(got[0]) == (rank ^ 1) + 10
        col.send(x + 20, dst_rank=(rank + 1) % WORLD, group_name="all")
        got = col.recv(src_rank=(rank - 1) % WORLD, group_name="all")
        assert float(got[0]) == (rank - 1) % WORLD + 20
        links = col.pair_links("all")
        torch.cuda.synchronize()
        p2p_ms, m2 = 1e3 * (time.perf_counter() - t0), _used(dev)
        if rank in HALF_RANK:
            peer = 1 - HALF_RANK[rank]
            col.send(x + 30, dst_rank=peer, group_name="half")
            got = col.recv(src_rank=peer, group_name="half")
            assert float(got[0]) == (5 - rank) + 30
        tree = col.allreduce({"w": x, "b": x + 1}, group_name="all")
        assert float(tree["w"][0]) == sum(range(WORLD))
        print(f"rank {rank} forming {forming}: groups made in {make_ms:.1f}"
              f" ms, +{m1 - m0} card bytes; first exchanges {p2p_ms:.1f} "
              f"ms; card bytes since the groups were made (the first "
              f"collectives' buffers included) +{m2 - m1}; links {links}",
              flush=True)
        if rank in HALF_RANK:
            col.destroy_collective_group("half")
        col.destroy_collective_group("all")


def main() -> int:
    if torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} cards", file=sys.stderr)
        return 2
    t0 = time.time()
    mp.spawn(_rank, nprocs=WORLD)
    print(f"point to point on {WORLD} cards passed in "
          f"{time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
