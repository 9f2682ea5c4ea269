"""Rank processes for the port's multi-process CPU tests (gloo).

The test process holds JAX and its threads, so ranks are new interpreters
(``subprocess``, never a fork) that import only ``torch`` and ``ufm_torch``.
They meet through a ``FileStore`` in the run's own directory (no port, so
parallel test workers do not collide), run one task each, write their
results there and exit. :class:`Ranks` waits for them under a wall-clock
limit and kills them all when it expires, so a hang fails one test.

    python tests/torch_port_ranks.py RUN_DIR RANK WORLD   # started by Ranks
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


class Ranks:
    """``world`` gloo ranks running one task (a dict naming functions of
    this module in ``"kinds"``, pickled with ``torch.save``); started at
    construction, so the caller can work while they run."""

    def __init__(self, task: Dict[str, Any], world: int, run_dir: Path, timeout: float = 240.0):
        run_dir.mkdir(parents=True, exist_ok=True)
        torch.save(task, run_dir / "task.pt")
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        self.run_dir, self.timeout = run_dir, timeout
        self.deadline = time.monotonic() + timeout
        self._logs = [open(run_dir / f"rank{r}.log", "w") for r in range(world)]
        self._procs = [
            subprocess.Popen([sys.executable, str(Path(__file__)), str(run_dir), str(r), str(world)],
                             cwd=ROOT, env=env, stdout=self._logs[r], stderr=subprocess.STDOUT)
            for r in range(world)
        ]
        self._results = None

    def results(self) -> List[Dict[str, Any]]:
        """Each rank's result dict. Waits until the wall-clock limit, then
        kills every rank; raises with the ranks' output when one failed or
        the time ran out."""
        if self._results is None:
            try:
                for p in self._procs:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
            finally:
                for p in self._procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for f in self._logs:
                    f.close()
            codes = [p.returncode for p in self._procs]
            if any(codes):
                tails = "\n".join(f"--- rank {r} (exit {c})\n" + (self.run_dir / f"rank{r}.log").read_text()[-3000:]
                                  for r, c in enumerate(codes))
                raise RuntimeError(f"ranks failed or timed out after {self.timeout} s: {codes}\n{tails}")
            self._results = [torch.load(self.run_dir / f"rank{r}.pt", weights_only=False) for r in range(len(codes))]
        return self._results


# ---- inside a rank ---------------------------------------------------------
def _net(state: Dict[str, np.ndarray], overrides: Dict[str, Any]):
    from ufm_torch.models import UFMNet, ufm_tiny_config

    net = UFMNet(ufm_tiny_config(**overrides))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return net


def _mesh(shape):
    from ufm_torch.parallel import make_mesh

    return make_mesh(data=shape[0], fsdp=shape[1], model=shape[2], device_type="cpu")


def _full_params(net) -> Dict[str, np.ndarray]:
    from ufm_torch.parallel.sharding import qkv_permutations, unshard

    perms = qkv_permutations(net)
    return {n: unshard(p.detach(), perms.get(n)).float().numpy().copy() for n, p in net.named_parameters()}


def _full_grads(net) -> Dict[str, np.ndarray]:
    from ufm_torch.parallel.sharding import qkv_permutations, unshard

    perms = qkv_permutations(net)
    return {n: unshard(p.grad, perms.get(n)).float().numpy().copy() for n, p in net.named_parameters()}


def _numpy(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def sharded_forward(task, rank, world):
    """The sharded net's forward on each mesh; outputs gathered over data."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from ufm_torch.parallel.sharding import shard_batch, shard_params

    out = {}
    for shape in task["meshes"]:
        mesh = _mesh(shape)
        net = _net(task["state"], task.get("overrides", {}))
        shard_params(net, mesh)
        img1, img2 = (shard_batch(torch.from_numpy(task[k]), mesh) for k in ("img1", "img2"))
        with torch.no_grad():
            res = net(img1, img2)
        gathered = {}
        for k, v in res.items():
            parts = [torch.empty_like(v) for _ in range(shape[0])]
            dist.all_gather(parts, v.contiguous(), group=mesh.get_group("data"))
            gathered[k] = torch.cat(parts).numpy()
        model_axis = {n: str(p.placements[-1] if isinstance(p, DTensor) and p.device_mesh.ndim == 3 else Replicate())
                      for n, p in net.named_parameters()}
        out[tuple(shape)] = {"outputs": gathered, "model_placements": model_axis}
    return out


def sharded_train(task, rank, world):
    """Steps of make_sharded_train_step: the metrics of each step; on rank 0
    also each step's clipped gradients and the parameters after the last
    (fp32), and each master's dtype and layout."""
    from ufm_torch.training import make_sharded_train_step

    out = {}
    for shape in task["meshes"]:
        mesh = _mesh(shape)
        net = _net(task["state"], task.get("overrides", {}))
        step, net, opt, place = make_sharded_train_step(net, mesh, learning_rate=task["lr"], warmup_steps=0,
                                                        total_steps=10)
        batch = place(task["batch"])
        local_valid = float(batch["valid"].sum()) if "valid" in batch else None
        metrics, grads = [], []
        for _ in range(task["steps"]):
            metrics.append(_numpy(step(batch)))
            grads.append(_full_grads(net))  # a collective: every rank gathers
        params = _full_params(net)
        masters = [(type(m).__name__, str(m.dtype)) for m in opt.masters().values()]
        out[tuple(shape)] = {"metrics": metrics, "local_valid": local_valid, "masters": masters}
        if rank == 0:
            out[tuple(shape)].update(grads=grads, params=params)
    return out


def data_parallel(task, rank, world):
    from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
    from ufm_torch.parallel import make_data_parallel_forward

    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(), seed=rank, device="cpu")
    if rank == 0:  # the other ranks' weights differ until replicated
        model.net.load_state_dict({k: torch.from_numpy(v) for k, v in task["state"].items()})
    forward = make_data_parallel_forward(model, _mesh(task["mesh"]))
    return {"outputs": _numpy(forward(task["img1"], task["img2"]))}


def sharded_fit(task, rank, world):
    """fit(mesh=...) resuming a single-device checkpoint; then a fresh fit
    that stops early and leaves a sharded run's checkpoint."""
    from ufm_torch.training import fit

    out = {}
    for name, (ckpt, batches) in task["runs"].items():
        net = _net(task["state"], {})
        res = fit(net, batches, num_steps=task["num_steps"], learning_rate=task["lr"], mesh=_mesh(task["mesh"]),
                  checkpoint_dir=ckpt, warmup_steps=0, log_every=0, log_fn=lambda line: None)
        out[name] = {"step": res["step"], "params": _full_params(res["net"])}
    return out


def main(run_dir: str, rank: int, world: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    run = Path(run_dir)
    store = dist.FileStore(str(run / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        task = torch.load(run / "task.pt", weights_only=False)
        result = {}
        for kind in task["kinds"]:  # "<function>" or "<function>:<label>"
            t0 = time.perf_counter()
            try:
                result[kind] = globals()[kind.split(":")[0]](task[kind], rank, world)
            except Exception:  # reported to the test, which fails on it
                traceback.print_exc()
                result[kind] = {"error": traceback.format_exc()}
            print(f"{kind}: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.save(result, run / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
