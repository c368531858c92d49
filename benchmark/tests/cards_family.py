"""A throwaway multi-card family for the tests of the harness's card
readings, shaped as a multi-card family is (benchmark/README.md): the
measuring process is rank 0 on devices[0] and starts one process a card
on the others (rank r on devices[r]), all joined in one torch.distributed
group; each process allocates bytes_for(rank) on its card and takes part
in one all_reduce, and cards() gathers the readings of the processes it
started through harness.gather_readings.

    python benchmark/tests/cards_family.py --rank R --world N \\
        --device cuda:R --backend nccl --init-method file:///... --bytes B

is one of the started processes.
"""

import argparse
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

MIB = 2 ** 20
TIMEOUT_S = 120


def bytes_for(rank):
    return (rank + 1) * 64 * MIB


def work(device, nbytes):
    """nbytes held on `device`, and one all_reduce over the group."""
    held = torch.empty(nbytes, dtype=torch.uint8, device=device)
    x = torch.ones(1, device=device)
    dist.all_reduce(x)
    if x.item() != dist.get_world_size():
        raise RuntimeError(f"all_reduce gave {x.item()}")
    return held


def join(backend, init_method, rank, world, device):
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))


class Family:
    """The family's side in the measuring process: rank 0."""

    def __init__(self, devices, backend, workdir):
        self.device = devices[0]
        init = "file://" + str(Path(workdir) / "store")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.logs = [Path(workdir) / f"rank{r}.log"
                     for r in range(1, len(devices))]
        self.procs = []
        for r, (dev, log) in enumerate(zip(devices[1:], self.logs), 1):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--rank", str(r), "--world",
                     str(len(devices)), "--device", str(dev), "--backend",
                     backend, "--init-method", init, "--bytes",
                     str(bytes_for(r))],
                    cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT))
        try:
            join(backend, init, 0, len(devices), self.device)
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            self.held = work(self.device, bytes_for(0))
        except BaseException:
            self.close(kill=True)
            raise

    def cards(self):
        return harness.gather_readings(self.device)[1:]

    def close(self, kill=False):
        """Leaves the group and waits for the started processes; kills
        them at once with `kill` (a family that failed to start)."""
        self.held = None
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs:
            if kill:
                p.kill()
            try:
                p.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def tails(self):
        return "\n".join(log.read_text()[-2000:] for log in self.logs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--bytes", type=int, required=True)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    join(args.backend, args.init_method, args.rank, args.world, device)
    held = work(device, args.bytes)
    harness.gather_readings(device)
    del held
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
