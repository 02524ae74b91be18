"""Port: multi-process sharded search over ``torch.distributed`` (gloo).

Two processes, two local shards each (a 4-shard ``gallery`` axis), joined
through ``parallel.distributed.initialize_distributed``, as
tests/test_pod_scale.py joins two JAX processes. ``ShardedIndex.query``,
``rank_candidates`` and the sharded IVF and PQ must equal single-device
search on a gallery of planted ties, in both processes. The worker is this
file run as a script; it imports the port only.
"""

import os
import socket
import subprocess
import sys
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(port: int, rank: int) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    from image_retrieval_for_image_based_localization_tpu_torch.parallel import (
        ShardedIndex,
        ShardedIVF,
        create_mesh,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
        initialize_distributed,
        is_primary,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_pq import (
        ShardedPQ,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import IVFIndex
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
        knn_search,
        rank_candidates,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import PQIndex

    torch.set_num_threads(2)
    if rank == 0:   # one process from arguments, the other from the JAX variables
        ok = initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=0,
                                    device="cpu")
    else:
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                          JAX_PROCESS_ID="1")
        ok = initialize_distributed(device="cpu")
    assert ok and dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    assert is_primary() == (rank == 0)
    mesh = create_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 1, "gallery": 4} and mesh.shard_id(1) == 2 * rank + 1
    print(f"DIST_OK rank={rank} world=2 shards=4", flush=True)

    rng = np.random.RandomState(0)  # the same gallery in both processes
    g = np.repeat(rng.randn(100, 32).astype(np.float32), 7, axis=0)[:699]  # ties, pad row
    q = rng.randn(5, 32).astype(np.float32)
    si = ShardedIndex(g, mesh=mesh)
    assert len(si.shards) == 2 and si.local_rows == 175
    s, i = si.query(q, k=20)
    s1, i1 = knn_search(torch.from_numpy(g), torch.from_numpy(q), 20)
    assert (i == i1.numpy()).all(), "index mismatch"
    assert (s == s1.numpy()).all(), "score mismatch"
    cand = np.concatenate([i1.numpy()[:, :6], rng.randint(0, 699, (5, 4))], 1)
    r = si.rank_candidates(q, cand)
    r1 = rank_candidates(torch.from_numpy(g), torch.from_numpy(q), torch.from_numpy(cand))
    assert (r == r1.numpy()).all() and (r[:, :6] == np.arange(6)).all(), r
    assert torch.equal(si.gallery_host(), torch.from_numpy(g))
    print(f"SHARDED_QUERY_OK rank={rank} idx_sum={int(i.sum())}", flush=True)

    gu = g / np.linalg.norm(g, axis=1, keepdims=True)
    ivf = IVFIndex.build(gu, n_clusters=6, device="cpu")
    for nprobe in (2, 6):
        assert (ShardedIVF(ivf, mesh=mesh).search(q, k=15, nprobe=nprobe)[1]
                == ivf.search(q, k=15, nprobe=nprobe)[1]).all(), nprobe
    pq = PQIndex.build(gu, m=4, device="cpu")
    sp, ip = ShardedPQ(pq, mesh=mesh).search(q, k=15)
    sp1, ip1 = pq.search(q, k=15)
    assert (ip == ip1).all() and (sp == sp1).all()
    print(f"SHARDED_ANN_OK rank={rank}", flush=True)
    dist.destroy_process_group()


def test_two_process_gloo_sharded_search():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(rank)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (rank, out[-3000:])
        for mark in (f"DIST_OK rank={rank} world=2 shards=4", f"SHARDED_QUERY_OK rank={rank}",
                     f"SHARDED_ANN_OK rank={rank}"):
            assert mark in out, out[-2000:]
    # both processes hold the same merged result
    assert len({o.split("idx_sum=")[1].split()[0] for o in outs}) == 1


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
