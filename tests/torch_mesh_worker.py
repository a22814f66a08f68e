"""Rank bodies for tests/test_torch_parallel.py's spawned gloo worlds.

Each function runs in a fresh interpreter that has already joined the
process group (pluto_gps_sim_tpu_torch.parallel.multiproc_dryrun
.spawn_world), imports only the PyTorch package, and writes its results
as .npy files into out_dir for the pytest process to hold against the
JAX package.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

FS = 1_000_000.0
RINEX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "brdc_test.23n")


def rank_body(rank: int, world: int, out_dir: str) -> None:
    """The mesh paths of the port on 4 CPU ranks:

    * IqStream(mode="kernel", mesh=2x2).generate(3) at 1 MHz / 32,768
      samples (3 blocks over 2 time shards: the padding path);
    * the same stream abandoned after its first 1-block group while the
      planner runs ahead, then resumed to 4 blocks (the collective-order
      rollback: a rank left a collective ahead would hang the world);
    * superframes_per_dispatch=2 with as_device=True, and a 6 MHz
      stream whose block splits into 2 sub-blocks;
    * MonteCarloBatch B=4 x 2 blocks over 2x2, and B=1 x 1 block over
      4x1 (1 block over 4 time shards), at 1 MHz / 16,384 samples."""
    from pluto_gps_sim_tpu_torch.ingest import read_rinex2
    from pluto_gps_sim_tpu_torch.ops import synth_cuda as sc
    from pluto_gps_sim_tpu_torch.parallel import MonteCarloBatch, make_mesh
    from pluto_gps_sim_tpu_torch.runtime import (select_ephemeris_set,
                                                 setup_scenario)
    from pluto_gps_sim_tpu_torch.runtime.stream import IqStream

    rin = read_rinex2(RINEX)
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    xyz = np.load(os.path.join(out_dir, "xyz.npy"))
    xyz_mc = np.load(os.path.join(out_dir, "xyz_mc.npy"))

    def save(name, arr):
        np.save(os.path.join(out_dir, f"{name}_{rank}.npy"), arr)

    t0 = time.perf_counter()
    mesh = make_mesh(2, 2, device="cpu")
    save("stream", IqStream(rin, g0, ieph, xyz, fs=FS, block_samples=32768,
                            device="cpu", mesh=mesh).generate(3))

    s = IqStream(rin, g0, ieph, xyz, fs=FS, block_samples=32768,
                 device="cpu", mesh=mesh)
    it = s.superframes(4, max_blocks=1)
    first = next(it)
    time.sleep(0.2 * rank)       # let the planners drift apart
    it.close()
    save("abandon", np.concatenate([first, s.generate(3)]))

    # dispatch groups of 1 and 2 one-block superframes, as_device words
    k2 = IqStream(rin, g0, ieph, xyz, fs=FS, block_samples=32768,
                  device="cpu", mesh=mesh, superframes_per_dispatch=2)
    save("k2", np.concatenate([
        sc.unpack_iq(w.numpy(), 32768)
        for w in k2.superframes(4, max_blocks=1, as_device=True)]))
    # fs = 6 MHz: one 600,000-sample block split into 2 sub-blocks
    save("split", IqStream(rin, g0, ieph, xyz, fs=6e6, device="cpu",
                           mesh=mesh).generate(1))

    save("mc22", MonteCarloBatch(rin, g0, ieph, xyz_mc, fs=FS,
                                 block_samples=16384).generate(
                                     2, "cpu", mesh=mesh))
    mesh41 = make_mesh(4, 1, device="cpu")
    save("mc41", MonteCarloBatch(rin, g0, ieph, xyz_mc[:1], fs=FS,
                                 block_samples=16384).generate(
                                     1, "cpu", mesh=mesh41))
    with open(os.path.join(out_dir, f"stats_{rank}.json"), "w") as f:
        json.dump({"coord": list(mesh.coord), "stats": mesh.stats,
                   "stats41": mesh41.stats, "launches": sc.launch_count(),
                   "seconds": time.perf_counter() - t0}, f)


def fail_on_rank1(rank: int, world: int) -> None:
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(600)


def sleep_forever(rank: int, world: int) -> None:
    time.sleep(600)
