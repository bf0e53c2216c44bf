"""Which torch.distributed collectives run on CUDA tensors, by backend.

Two gloo ranks share card 0 (``torch.cuda.set_device(0)`` in each) and
try all_reduce, broadcast, all_gather_into_tensor,
reduce_scatter_tensor, all_to_all_single, batch_isend_irecv and a
blocking send/recv on CUDA tensors, checking each result against its
definition. Each call runs in a pair of processes of its own, all pairs
at once: a call gloo cannot make on device memory may abort its
process (it is then reported as "crashed", with the exit code). Then one NCCL rank (world size 1) runs the same calls, and
an all_reduce captured in a CUDA graph and replayed. Prints one JSON
object: {"torch": ..., "cuda": ..., "gloo_cuda": {name: "ok" | error},
"nccl_world1": {...}}.

Run on a machine with a card: ``python3 scripts/torch_collective_probe.py``.
"""

from __future__ import annotations

import json
import os
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cases(rank: int, world: int, dev):
    """(name, thunk returning True when the result is right)."""
    def t(*vals):
        return torch.tensor(vals, dtype=torch.float32, device=dev)

    x = t(*[float(4 * rank + i) for i in range(4)])

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        want = sum(t(*[float(4 * r + i) for i in range(4)])
                   for r in range(world))
        return torch.equal(y, want)

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return torch.equal(y, t(0.0, 1.0, 2.0, 3.0))

    def all_gather_into_tensor():
        y = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(y, x)
        return torch.equal(y, torch.arange(4.0 * world, device=dev))

    def reduce_scatter_tensor():
        y = torch.empty(4 // world if world <= 4 else 1, device=dev)
        z = torch.arange(4.0, device=dev)
        dist.reduce_scatter_tensor(y, z)
        n = 4 // world
        return torch.equal(y, world * z[rank * n:(rank + 1) * n])

    def all_to_all_single():
        y = torch.empty(4, device=dev)
        dist.all_to_all_single(y, x)
        n = 4 // world
        want = torch.cat([t(*[float(4 * r + rank * n + i)
                              for i in range(n)]) for r in range(world)])
        return torch.equal(y, want)

    def batch_isend_irecv():
        y = torch.empty(4, device=dev)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        src = (rank - 1) % world
        return torch.equal(y, t(*[float(4 * src + i) for i in range(4)]))

    def send_recv():
        if world == 1:
            return True
        y = torch.empty(4, device=dev)
        if rank == 0:
            dist.send(x, 1)
            dist.recv(y, 1)
        else:
            dist.recv(y, 0)
            dist.send(x, 0)
        other = 1 - rank
        return torch.equal(y, t(*[float(4 * other + i) for i in range(4)]))

    return [("all_reduce", all_reduce), ("broadcast", broadcast),
            ("all_gather_into_tensor", all_gather_into_tensor),
            ("reduce_scatter_tensor", reduce_scatter_tensor),
            ("all_to_all_single", all_to_all_single),
            ("batch_isend_irecv", batch_isend_irecv),
            ("send_recv", send_recv)]


def _run_cases(rank, world, dev) -> dict:
    out = {}
    for name, fn in _cases(rank, world, dev):
        try:
            ok = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "wrong result"
        except Exception as e:  # noqa: BLE001 - the answer is the error
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        dist.barrier()
    return out


def _gloo_rank(rank, world, port, name, queue):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        fn = dict(_cases(rank, world, torch.device("cuda", 0)))[name]
        try:
            ok = fn()
            torch.cuda.synchronize()
            res = "ok" if ok else "wrong result"
        except Exception as e:  # noqa: BLE001 - the answer is the error
            res = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        queue.put((name, rank, res))
    finally:
        dist.destroy_process_group()


def _nccl_world1(port) -> dict:
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        res = _run_cases(0, 1, torch.device("cuda", 0))
        x = torch.ones(1024, device="cuda")
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(s):
                dist.all_reduce(x)   # warm-up outside the capture
            torch.cuda.current_stream().wait_stream(s)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = x * 2
                dist.all_reduce(y)
            x.fill_(3.0)
            g.replay()
            torch.cuda.synchronize()
            res["all_reduce_in_cuda_graph"] = (
                "ok" if bool((y == 6.0).all()) else "wrong result")
        except Exception as e:  # noqa: BLE001
            res["all_reduce_in_cuda_graph"] = (
                f"{type(e).__name__}: {str(e).splitlines()[0][:160]}")
        return res
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    names = [name for name, _ in _cases(0, 2, "cpu")]
    procs = {}
    for name in names:
        port = _free_port()
        procs[name] = [ctx.Process(target=_gloo_rank,
                                   args=(r, 2, port, name, queue))
                       for r in range(2)]
        for p in procs[name]:
            p.start()
    answers = {}
    for name in names:
        for p in procs[name]:
            p.join(180)
            if p.is_alive():
                p.kill()
                p.join()
    while not queue.empty():
        name, rank, res = queue.get()
        answers.setdefault(name, {})[rank] = res
    gloo = {}
    for name in names:
        got = answers.get(name, {})
        if len(got) == 2:
            gloo[name] = got[0] if got[0] == got[1] else f"{got[0]} / {got[1]}"
        else:
            codes = [p.exitcode for p in procs[name]]
            gloo[name] = f"crashed (exit codes {codes}; answers {got})"
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    nccl = _nccl_world1(_free_port())
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0],
                      "gloo_cuda": gloo, "nccl_world1": nccl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
