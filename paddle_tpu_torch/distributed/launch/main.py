"""``python -m paddle_tpu_torch.distributed.launch``: the collective
launcher.

Counterpart of ``paddle_tpu/distributed/launch/main.py``'s collective
controller (Paddle's ``launch/main.py`` and
``launch/controllers/collective.py``), for one node::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        [--master 127.0.0.1:PORT] [--devices 0,1 | 0,0 | cpu] \\
        [--log_dir log] [--job_id default] script.py [script args]

It hosts a ``torch.distributed.TCPStore`` at ``--master`` (a free local
port by default), starts one process per rank with the same ``PADDLE_*``
environment (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE``, ``PADDLE_NNODES``,
``PADDLE_MASTER``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_JOB_ID``, ``FLAGS_selected_gpus``
and ``PADDLE_WORLD_DEVICES``), writes each rank's output to
``<log_dir>/<job_id>.rank<r>.log``, and returns 0 when every rank
succeeds, else the exit code of the first rank that failed (the others
are stopped).

``--devices`` gives each local rank its card (``0,1``), lets ranks share
one (``0,0``: the job then runs over gloo, ``parallel.choose_backend``),
or runs them on the CPU (``cpu``).  Without it every rank takes a card of
its own, and fewer cards than ranks raises.  Elastic runs,
``--max_restart`` and the pod detection of the JAX launcher are not
ported (ROADMAP.md A.8).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from datetime import timedelta
from typing import List

__all__ = ["launch", "parse_args", "CollectiveController"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle_tpu_torch collective launcher (one node)")
    p.add_argument("--master", default=None,
                   help="host:port of the rendezvous store (default: a "
                        "free local port)")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--log_dir", default="log")
    p.add_argument("--job_id", default="default")
    p.add_argument("--devices", default=None,
                   help="each local rank's card id (comma list), or cpu")
    p.add_argument("--run_mode", default="collective",
                   choices=["collective"])
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _rank_devices(spec, nproc: int) -> List[str]:
    """Each local rank's device as the environment writes it: a card id
    or ``cpu``."""
    if spec:
        devs = [d.strip() for d in spec.split(",") if d.strip()]
        if devs == ["cpu"]:
            return ["cpu"] * nproc
        if len(devs) != nproc:
            raise ValueError(f"--devices names {len(devs)} devices for "
                             f"{nproc} ranks")
        return devs
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < nproc:
        raise ValueError(
            f"--nproc_per_node {nproc} needs {nproc} cards, this machine "
            f"has {n}; name the devices (--devices 0,0 to share one, "
            "--devices cpu for CPU ranks)")
    return [str(i) for i in range(nproc)]


class CollectiveController:
    """One node's ranks: start, watch, stop."""

    def __init__(self, args):
        self.args = args
        self.nproc = int(args.nproc_per_node)
        if self.nproc < 1:
            raise ValueError(f"--nproc_per_node {self.nproc}")
        self.devices = _rank_devices(args.devices, self.nproc)
        self.procs: List[subprocess.Popen] = []
        self.logs = []
        self.store = None

    def rendezvous(self) -> str:
        """Host the job's store; returns its ``host:port``."""
        import torch.distributed as dist
        host, port = "127.0.0.1", 0
        if self.args.master:
            host, port = self.args.master.rsplit(":", 1)
        self.store = dist.TCPStore(host, int(port), None, True,
                                   timedelta(seconds=1800),
                                   wait_for_workers=False)
        return f"{host}:{self.store.port}"

    def _env(self, rank: int, master: str) -> dict:
        env = dict(os.environ)
        host = master.rsplit(":", 1)[0]
        base = int(master.rsplit(":", 1)[1])
        eps = [f"{host}:{base + 1 + r}" for r in range(self.nproc)]
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(self.nproc),
            "PADDLE_LOCAL_RANK": str(rank),
            "PADDLE_LOCAL_SIZE": str(self.nproc),
            "PADDLE_NNODES": "1",
            "PADDLE_MASTER": master,
            "PADDLE_CURRENT_ENDPOINT": eps[rank],
            "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
            "PADDLE_JOB_ID": self.args.job_id,
            "FLAGS_selected_gpus": self.devices[rank],
            "PADDLE_WORLD_DEVICES": ",".join(self.devices),
        })
        return env

    def start(self) -> None:
        master = self.rendezvous()
        os.makedirs(self.args.log_dir, exist_ok=True)
        for rank in range(self.nproc):
            path = os.path.join(self.args.log_dir,
                                f"{self.args.job_id}.rank{rank}.log")
            logf = open(path, "wb")
            cmd = [sys.executable, "-u", self.args.training_script,
                   *self.args.training_script_args]
            self.procs.append(subprocess.Popen(
                cmd, env=self._env(rank, master), stdout=logf,
                stderr=subprocess.STDOUT))
            self.logs.append(logf)

    def watch(self, poll_s: float = 0.05) -> int:
        """0 once every rank exits 0; else the first failing rank's code,
        after stopping the rest."""
        while True:
            codes = [p.poll() for p in self.procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                rank, code = bad[0]
                sys.stderr.write(f"[launch] rank {rank} exited with code "
                                 f"{code}; stopping the others\n")
                self.stop()
                return code
            if all(c == 0 for c in codes):
                self.stop()
                return 0
            time.sleep(poll_s)

    def stop(self, sig=signal.SIGTERM, grace_s: float = 10.0) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(sig)
        end = time.monotonic() + grace_s
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()
        self.logs = []

    def run(self) -> int:
        self.start()
        return self.watch()


def launch(argv=None) -> int:
    controller = CollectiveController(parse_args(argv))

    def handler(sig, frame):
        controller.stop()
        sys.exit(128 + sig)

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    return controller.run()


if __name__ == "__main__":
    sys.exit(launch())
