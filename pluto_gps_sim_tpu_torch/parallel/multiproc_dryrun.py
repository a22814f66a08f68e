"""Multi-process sharded-synthesis dryruns over torch.distributed.

The counterpart of the JAX package's ``parallel/multiproc_dryrun.py``
(and of ``__graft_entry__.dryrun_multichip``).  N fresh interpreters,
one rank each, join one process group (TCP rendezvous on 127.0.0.1, a
free port) and run the checks of the JAX dryrun over a
parallel.mesh.Mesh whose channel axis spans the processes:

run_multiprocess_dryrun (worker_body):
  1. synthetic-parameter sharded synthesis, checked word for word
     against an unsharded run on the rank's own device;
  2. the REAL RINEX fixture host-partitioned with
     IqStream(n_hosts=N, host_id=rank): each rank fast-forwards the
     control plane to its share and synthesizes only its blocks; its
     partial stream must equal the same slice of a full run;
  3. the real scheduler's plan_group parameters through the mesh,
     again word for word against the unsharded run.

dryrun_multichip (multichip_body): a synthetic group, and a real
scheduler group at 16,384 samples through the mesh, each against the
single-rank result.

Each rank prints a tag naming itself; the coordinator requires every
rank's tag and exit code 0, and kills every rank and raises when one
fails or the run outlasts its timeout.  spawn_world is the general
launcher both use (chip_smoke.py and the tests run their own rank
bodies through it).

Reference contrast: the reference is a single process whose only
parallelism is one generator thread + one TX thread over a mutex
(plutogpssim.c:2689-2759).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ["run_multiprocess_dryrun", "dryrun_multichip", "spawn_world",
           "rank_device", "check_world_device", "single_device",
           "worker_body", "multichip_body", "OK_TAG", "MULTICHIP_TAG"]

OK_TAG = "MULTIPROC_DRYRUN OK"
MULTICHIP_TAG = "dryrun_multichip OK"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RINEX = os.path.join(REPO, "tests", "data", "brdc_test.23n")

# Each rank: join the process group FIRST, then import and run the body
# (argv: rank world init_method backend timeout module:function args...)
_STUB = """\
import datetime, importlib, sys
rank, world = int(sys.argv[1]), int(sys.argv[2])
init, backend, timeout, target = sys.argv[3:7]
import torch
import torch.distributed as dist
dist.init_process_group(backend, init_method=init, world_size=world,
                        rank=rank,
                        timeout=datetime.timedelta(seconds=float(timeout)))
torch.set_num_threads(1)
mod, fn = target.split(":")
getattr(importlib.import_module(mod), fn)(rank, world, *sys.argv[7:])
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(n_processes: int, backend: str, target: str,
                args: tuple = (), timeout: float = 300.0) -> list[str]:
    """Run target(rank, world, *args) in n_processes fresh interpreters
    joined in one torch.distributed process group; returns each rank's
    combined stdout and stderr.

    target is "module:function", imported after the group is up, on the
    caller's import path.  Raises RuntimeError, after killing every
    rank, as soon as one exits non-zero or when the world outlasts
    timeout seconds (also each rank's collective timeout)."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in sys.path if p])
    env["OMP_NUM_THREADS"] = "1"
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(n_processes)]
    procs: list[subprocess.Popen] = []
    try:
        for rank in range(n_processes):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _STUB, str(rank), str(n_processes),
                 init, backend, str(timeout), target, *map(str, args)],
                stdout=logs[rank], stderr=subprocess.STDOUT, env=env,
                cwd=REPO))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None:
            rcs = [p.poll() for p in procs]
            if all(rc == 0 for rc in rcs):
                break
            failed = next((r for r, rc in enumerate(rcs)
                           if rc not in (None, 0)), None)
            if failed is None and time.monotonic() > deadline:
                failed = -1
            if failed is None:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failed is not None:
        what = (f"timed out after {timeout:.0f} s" if failed < 0 else
                f"rank {failed} exited {procs[failed].returncode}")
        raise RuntimeError(f"{target} on {n_processes} ranks ({backend}) "
                           f"{what}:\n" + "\n".join(
                               f"--- rank {r} ---\n{o}"
                               for r, o in enumerate(outs)))
    return outs


def rank_device(device: str, rank: int) -> str:
    """'cuda:rank' names rank r's card r; any other name is used as is."""
    return f"cuda:{rank}" if device == "cuda:rank" else device


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _real_scenario():
    """(rin, g0, ieph, xyz) from the tracked RINEX fixture, Tokyo static
    receiver — the real ingest -> scenario -> scheduler path."""
    import numpy as np

    from ..ingest import read_rinex2
    from ..models.geodesy import llh2xyz
    from ..runtime import select_ephemeris_set, setup_scenario

    rin = read_rinex2(RINEX)
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    llh = np.array([35.681298, 139.766247, 10.0]) / \
        np.array([57.2957795131, 57.2957795131, 1.0])
    return rin, g0, ieph, np.asarray(llh2xyz(llh))


def single_device(dev, arrays, block_samples: int):
    """The unsharded packed output of kernel inputs (prmi, prmf,
    ca_tabs, sf_map) on one device, as numpy."""
    import torch

    from ..ops import synth_cuda as sc
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    return sc.synth_blocks(*args, block_samples).cpu().numpy()


def _check_on_mesh(mesh, arrays, block_samples: int, what: str) -> int:
    """Kernel inputs through the mesh (padded, channel-sharded) against
    the unsharded run on the rank's device, word for word; returns the
    block count."""
    import numpy as np

    from .shard import pad_time_shards, shard_channel_params, synth_sharded
    prmi, prmf, ca_tabs, sf_map = arrays
    prmi_p, prmf_p, sf_p = pad_time_shards(prmi, prmf, sf_map,
                                           mesh.shape["time"])
    got = synth_sharded(mesh, prmi_p,
                        shard_channel_params(prmf_p, mesh.shape["chan"]),
                        ca_tabs, sf_p, block_samples)[:sf_map.size]
    got = got.cpu().numpy()
    want = single_device(mesh.device, arrays, block_samples)
    _check(got.shape == want.shape, f"{what}: {got.shape} != {want.shape}")
    _check(np.array_equal(got, want), f"{what}: sharded output differs "
           f"from the unsharded run in {int((got != want).sum())} words")
    return want.shape[0]


def worker_body(pid: int, nproc: int, device: str) -> None:
    """One rank of run_multiprocess_dryrun (runs after the process group
    is up; see _STUB)."""
    import numpy as np

    from ..runtime.launch import pack_group
    from ..runtime.stream import IqStream
    from .mesh import make_mesh
    from .synthetic import synthetic_params

    # the default factoring puts chan across processes whenever N > 1
    mesh = make_mesh(device=rank_device(device, pid))
    n_time, n_chan = mesh.shape["time"], mesh.shape["chan"]
    n_syn = _check_on_mesh(mesh, synthetic_params(2 * n_time, 32768),
                           32768, f"rank {pid}: synthetic")

    # ---- phase 2: REAL scenario, host-partitioned stream ----------------
    fs, bs, n_total = 1_000_000.0, 8192, 24
    rin, g0, ieph, xyz = _real_scenario()
    full = np.concatenate(list(IqStream(
        rin, g0, ieph, xyz, fs=fs, block_samples=bs,
        device=mesh.device).superframes(n_total, max_blocks=6)), axis=0)
    part = IqStream(rin, g0, ieph, xyz, fs=fs, block_samples=bs,
                    device=mesh.device, superframes_per_dispatch=2,
                    n_hosts=nproc, host_id=pid)
    mine = np.concatenate(list(part.superframes(n_total, max_blocks=6)),
                          axis=0)
    lo = pid * n_total // nproc
    hi = (pid + 1) * n_total // nproc
    _check(mine.shape[0] == hi - lo, f"rank {pid}: {mine.shape} for "
           f"[{lo},{hi})")
    _check(np.array_equal(mine, full[lo:hi]),
           f"rank {pid}: host-partitioned stream diverges in [{lo},{hi})")

    # ---- phase 3: the real scenario's params through the mesh -----------
    sched = IqStream(rin, g0, ieph, xyz, fs=fs, block_samples=bs,
                     device=mesh.device).sched
    group = pack_group(sched.plan_group(2, max_blocks=4))
    n_real = _check_on_mesh(mesh, group.arrays, group.block_samples,
                            f"rank {pid}: real scenario")

    print(f"{OK_TAG}: process {pid}/{nproc}, mesh time={n_time} "
          f"chan={n_chan} (chan spans processes) over "
          f"{mesh.backend} on {mesh.device}: {n_syn} synthetic blocks "
          f"bit-exact; real-scenario host partition [{lo},{hi}) "
          f"byte-identical; {n_real} real-scenario blocks through the "
          f"mesh bit-exact", flush=True)


def multichip_body(pid: int, nproc: int, device: str) -> None:
    """One rank of dryrun_multichip: a synthetic group and a real
    scheduler group at 16,384 samples through the default mesh."""
    from ..runtime.launch import pack_group
    from ..runtime.scheduler import Scheduler
    from .mesh import make_mesh
    from .synthetic import synthetic_params

    mesh = make_mesh(device=rank_device(device, pid))
    n_time, n_chan = mesh.shape["time"], mesh.shape["chan"]
    n_syn = _check_on_mesh(mesh, synthetic_params(2 * n_time, 32768),
                           32768, f"rank {pid}: synthetic")
    print(f"{MULTICHIP_TAG}: rank {pid}/{nproc} mesh time={n_time} "
          f"chan={n_chan}, {n_syn} blocks x 32768 samples, all-reduce "
          f"composite matches single-device bit-for-bit", flush=True)

    rin, g0, ieph, xyz = _real_scenario()
    # small device blocks keep the dryrun fast; the control plane is
    # the full production scheduler
    sched = Scheduler(rin, g0, ieph, xyz, fs=2_600_000.0,
                      block_samples=16384)
    plans = sched.plan_group(2, max_blocks=n_time)
    group = pack_group(plans)
    n_real = _check_on_mesh(mesh, group.arrays, group.block_samples,
                            f"rank {pid}: real group")
    n_act = max(int(p.active.any(axis=0).sum()) for p in plans)
    print(f"{MULTICHIP_TAG}: rank {pid}/{nproc} real-RINEX scheduler group "
          f"({len(plans)} superframes, {n_real} blocks, {n_act} active "
          f"channels) all-reduce composite matches single-device "
          f"bit-for-bit", flush=True)


def check_world_device(device: str, n: int) -> None:
    """Raise before any rank is spawned unless every rank of an n-rank
    world can open `device` (see run_multiprocess_dryrun): "cuda" needs
    a card torch can see, "cuda:rank" one card per rank."""
    from ..ops.synth_torch import resolve_device
    resolve_device(rank_device(device, 0))
    if device == "cuda:rank":
        import torch
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"device 'cuda:rank' needs {n} CUDA devices, "
                               f"torch sees {torch.cuda.device_count()}")


def _run_tagged(n: int, backend: str, body: str, device: str,
                timeout: float, tags: list[str]) -> str:
    check_world_device(device, n)
    outs = spawn_world(n, backend, f"{__package__}.multiproc_dryrun:{body}",
                       (device,), timeout)
    for rank, out in enumerate(outs):
        for tag in tags:
            if tag.format(rank=rank, n=n) not in out:
                raise RuntimeError(f"{body}: rank {rank} printed no "
                                   f"{tag.format(rank=rank, n=n)!r}:\n{out}")
    return "\n".join(outs)


def run_multiprocess_dryrun(n_processes: int = 4, backend: str = "gloo",
                            device: str = "cuda",
                            timeout: float = 300.0) -> str:
    """Spawn the worker_body ranks; returns their combined output.

    device: "cuda" (the default: every rank on the current card, gloo
    only, since NCCL refuses two ranks on one card), "cuda:rank" (rank r
    on card r) or "cpu".  Raises on any failure (a device the ranks
    cannot open, checked before anything is spawned; a non-zero exit; a
    missing tag; the timeout)."""
    return _run_tagged(n_processes, backend, "worker_body", device, timeout,
                       [OK_TAG + ": process {rank}/{n},"])


def dryrun_multichip(n_devices: int = 4, backend: str = "gloo",
                     device: str = "cuda", timeout: float = 300.0) -> str:
    """Spawn the multichip_body ranks (devices as for
    run_multiprocess_dryrun); returns their combined output."""
    return _run_tagged(n_devices, backend, "multichip_body", device,
                       timeout, [MULTICHIP_TAG + ": rank {rank}/{n} mesh",
                                 MULTICHIP_TAG + ": rank {rank}/{n} real"])


def main(argv: list[str] | None = None) -> None:
    """python -m pluto_gps_sim_tpu_torch.parallel.multiproc_dryrun [N]
    [--device cuda|cpu]: the whole coordinator + workers check over gloo,
    on the card unless asked otherwise."""
    import argparse
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("n", nargs="?", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    print(run_multiprocess_dryrun(a.n, device=a.device))


if __name__ == "__main__":
    main()
