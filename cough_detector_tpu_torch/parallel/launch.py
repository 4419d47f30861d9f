"""One rank a device of a mesh: the processes behind `train(mesh=...)`.

The JAX package trains over a mesh in one process, and XLA places the
collectives. The port's data parallelism is a `torch.distributed` process
group of one rank a device (BatchNorm's batch sums cross the ranks inside
the forward pass), so a call that trains over a mesh starts those ranks, as
torchrun does:

    run_ranks(mesh, entry, kwargs)

starts `python -m cough_detector_tpu_torch.parallel.launch CALL_DIR` once
per device of the mesh, with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR=127.0.0.1, MASTER_PORT a free
port, OMP_NUM_THREADS=1 unless set) and the caller's import path. Rank r
joins the group and calls `entry(**kwargs, device=mesh.devices[r])`. The
backend is "nccl" when every device is a distinct card, else "gloo" (a
card that repeats, or the CPU): NCCL takes one rank a card. The entry and
its arguments travel pickled in CALL_DIR, a temporary directory; rank 0's
result comes back the same way.

Rank 0's output (stdout and stderr) goes to the caller's stdout as it
comes; the other ranks' is kept, its tail for an error, and all of it in
`$CDT_RANK_LOG_DIR/rank<r>.log` when that variable names a directory. On
the first rank that fails, every other rank is killed (each runs in its
own session, so whatever it started goes too) and the call raises
RuntimeError naming the rank whose error came first, its exit code and the
tail of its output.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict

import torch

from .mesh import Mesh, maybe_initialize_distributed

_MODULE = "cough_detector_tpu_torch.parallel.launch"
_TAIL_LINES = 60
_GRACE_S = 2.0


def mesh_backend(mesh: Mesh) -> str:
    """The process group's backend for one rank a device of `mesh`."""
    devices = mesh.devices
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    """Kill each live child's session (the child and what it started)."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _first_error(call_dir: Path, first_exit: int) -> tuple:
    """(rank, error text) of the failure that came first: the earliest
    error a rank recorded before exiting, else the first non-zero exit seen
    (a rank that dies of a signal records none)."""
    recorded = []
    for path in call_dir.glob("error*.json"):
        rec = json.loads(path.read_text())
        recorded.append((rec["time"], rec["rank"], rec["error"]))
    if recorded:
        _, rank, text = min(recorded)
        return rank, text
    return first_exit, None


def run_ranks(mesh: Mesh, entry: Callable, kwargs: Dict[str, Any]) -> Any:
    """Run `entry(**kwargs, device=mesh.devices[r])` in one child process
    per device of `mesh`, joined in one process group; returns rank 0's
    result. `entry` and `kwargs` must pickle (a function by its import
    path). Raises RuntimeError when a rank fails, after killing the
    others; nothing falls back to one process."""
    world = mesh.size
    log_dir = os.environ.get("CDT_RANK_LOG_DIR")
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
    call_dir = Path(tempfile.mkdtemp(prefix="cdt-ranks-"))
    sink = sys.stdout
    procs, threads, logs = [], [], []
    tails = [collections.deque(maxlen=_TAIL_LINES) for _ in range(world)]
    exits: "queue.Queue[tuple]" = queue.Queue()

    def pump(rank: int, proc: subprocess.Popen, log) -> None:
        for line in proc.stdout:
            tails[rank].append(line)
            if log is not None:
                log.write(line)
            if rank == 0:
                sink.write(line)
                sink.flush()
        exits.put((rank, proc.wait()))

    try:
        torch.save(
            {"entry": entry, "kwargs": kwargs, "devices": [str(d) for d in mesh.devices],
             "backend": mesh_backend(mesh)},
            call_dir / "call.pt",
        )
        env = dict(os.environ)
        env.update({
            "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
            "PYTHONPATH": os.pathsep.join(p for p in sys.path if p), "PYTHONUNBUFFERED": "1",
        })
        env.setdefault("OMP_NUM_THREADS", "1")
        for r in range(world):
            proc = subprocess.Popen(
                [sys.executable, "-m", _MODULE, str(call_dir)],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, errors="replace",
                start_new_session=True,
            )
            procs.append(proc)
            log = open(Path(log_dir) / f"rank{r}.log", "w") if log_dir else None
            logs.append(log)
            threads.append(threading.Thread(target=pump, args=(r, proc, log), name=f"cdt-rank{r}", daemon=True))
            threads[-1].start()
        first_exit = None
        for _ in range(world):
            rank, code = exits.get()
            if code != 0:
                first_exit = rank
                break
        if first_exit is not None:
            # The ranks that exit on their own within a grace keep their
            # exit codes; the ones still waiting on the failed rank are killed.
            deadline = time.monotonic() + _GRACE_S
            while time.monotonic() < deadline and any(p.poll() is None for p in procs):
                time.sleep(0.05)
            _kill(procs)
            for t in threads:
                t.join()
            rank, error = _first_error(call_dir, first_exit)
            raise RuntimeError(
                f"rank {rank} of {world} failed (exit code {procs[rank].wait()})"
                + (f": {error.strip().splitlines()[-1]}" if error else "")
                + f"; the tail of its output:\n{''.join(tails[rank])}"
            )
        return torch.load(call_dir / "result.pt", weights_only=False)
    finally:
        _kill(procs)
        for p in procs:
            p.wait()
        for t in threads:
            t.join()
        for log in logs:
            if log is not None:
                log.close()
        shutil.rmtree(call_dir, ignore_errors=True)


def _rank_main(call_dir: str) -> None:
    """A child rank: join the group, call the entry on this rank's device,
    leave the group; rank 0 saves the result. An error is recorded (time,
    rank, traceback) before it propagates, so the parent can tell the
    first failure from the ranks that failed after it."""
    import torch.distributed as dist

    call_path = Path(call_dir)
    rank = int(os.environ["RANK"])
    error = call_path / f"error{rank}.json"

    def record() -> None:
        if not error.exists():
            error.write_text(json.dumps({"time": time.time(), "rank": rank, "error": traceback.format_exc()}))

    try:
        call = torch.load(call_path / "call.pt", weights_only=False)
        device = torch.device(call["devices"][rank])
        if not maybe_initialize_distributed(call["backend"], device=device):
            raise RuntimeError("the rank's torchrun environment is incomplete")
        print(f"Rank {rank} of {len(call['devices'])} joined the {call['backend']} group on {device}", flush=True)
        try:
            result = call["entry"](**call["kwargs"], device=device)
        except BaseException:
            record()  # before leaving the group, which fails the ranks waiting on this one
            raise
        finally:
            dist.destroy_process_group()
    except BaseException:
        record()
        raise
    if rank == 0:
        torch.save(result, call_path / "result.pt")


if __name__ == "__main__":
    _rank_main(sys.argv[1])
