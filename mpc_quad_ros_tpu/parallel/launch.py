"""Local multi-process launcher — the CPU stand-in for a multi-host pod.

Spawns N copies of `mp_worker` on localhost (each with K virtual CPU
devices, gloo collectives) and collects their npz results.  This is the
test/bench harness for the multi-host code path; on real hosts you launch
`mp_worker` yourself, one process per host, and skip this file.  Every
worker is pinned to the CPU (JAX_PLATFORMS=cpu, --platform cpu), so the
launcher never opens a GPU: a card takes one JAX process at a time.

    python -m mpc_quad_ros_tpu.parallel.launch --nproc 2 --devices 4 \
        --global-batch 1024
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_workers(nproc: int = 2, devices_per_process: int = 4,
                   global_batch: int = 1024, qp_iters: int = 2,
                   ticks: int = 0, repeats: int = 1, chain: int = 1,
                   timeout: float = 1800.0) -> list[dict]:
    """Run the SPMD worker in `nproc` local processes; returns their result
    dicts ordered by process id.  Raises on any nonzero exit (with the
    worker's captured output in the message)."""
    port = free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as td:
        procs = []
        outs = []
        for pid in range(nproc):
            out = os.path.join(td, f"shard{pid}.npz")
            outs.append(out)
            env = dict(os.environ)
            env["JAX_PLATFORMS"] = "cpu"
            env.pop("JAX_COMPILATION_CACHE_DIR", None)
            # drop any inherited device-count flag (pytest's conftest sets 8
            # for the parent) so the worker's own value is the only one
            flags = [f for f in env.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f]
            env["XLA_FLAGS"] = " ".join(flags)
            cmd = [sys.executable, "-m", "mpc_quad_ros_tpu.parallel.mp_worker",
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(nproc), "--process-id", str(pid),
                   "--global-batch", str(global_batch),
                   "--qp-iters", str(qp_iters), "--ticks", str(ticks),
                   "--repeats", str(repeats), "--chain", str(chain),
                   "--devices-per-process", str(devices_per_process),
                   "--platform", "cpu", "--out", out]
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=repo_root, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        failed = []
        for pid, pr in enumerate(procs):
            try:
                log, _ = pr.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for p2 in procs:
                    p2.kill()
                raise RuntimeError(f"mp_worker {pid} timed out after {timeout}s")
            logs.append(log)
            if pr.returncode != 0:
                failed.append((pid, pr.returncode, log))
        if failed:
            pid, rc, log = failed[0]
            raise RuntimeError(
                f"mp_worker {pid} exited {rc}:\n{log[-4000:]}")
        results = []
        for out in outs:
            with np.load(out) as z:
                results.append({k: z[k] for k in z.files})
        return results


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=1024)
    ap.add_argument("--qp-iters", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=1)
    a = ap.parse_args(argv)
    res = launch_workers(a.nproc, a.devices, a.global_batch, a.qp_iters,
                         a.ticks, a.repeats)
    for r in res:
        extra = (f", {float(r['solves_per_sec']):.0f} solves/s"
                 if "solves_per_sec" in r else "")
        print(f"process {int(r['process_id'])}: local U {r['U_local'].shape}, "
              f"global kkt_sum {float(r['kkt_sum']):.3e}{extra}")


if __name__ == "__main__":
    main()
