"""A pool of gloo ranks for the port's parallel tests, spawned once per
module, and the jobs they run.

``RankPool(world)`` starts ``world`` processes (the ``spawn`` start
method), each joined to one gloo group on a free localhost port at one
torch thread; ``pool.run(job, **kwargs)`` runs the module-level function
``job(**kwargs)`` in every rank and returns the ranks' results in rank
order. A rank that raises fails the call with its traceback; a call
that has not answered within ``timeout`` seconds (a hung collective)
kills the pool and fails. This module imports no JAX: the ranks run the
port alone, and the tests hold their results against the JAX package
in the pytest process.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, inq, outq):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel.multihost import (
        initialize_multihost,
    )

    initialize_multihost(f"tcp://127.0.0.1:{port}", world, rank,
                         backend="gloo", device="cpu")
    while True:
        item = inq.get()
        if item is None:
            break
        fn, kwargs = item
        try:
            outq.put((rank, True, fn(**kwargs)))
        except BaseException:  # noqa: BLE001 - reported to the caller
            outq.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int, timeout: float = 120.0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._out = ctx.Queue()
        self._ins = [ctx.Queue() for _ in range(world)]
        port = free_port()
        self._procs = [ctx.Process(target=_serve,
                                   args=(r, world, port, self._ins[r],
                                         self._out), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn, **kwargs) -> list:
        for q in self._ins:
            q.put((fn, kwargs))
        got = {}
        try:
            while len(got) < self.world:
                rank, ok, res = self._out.get(timeout=self.timeout)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{res}")
                got[rank] = res
        except queue_mod.Empty:
            self.close(kill=True)
            raise TimeoutError(
                f"{fn.__name__}: no answer from ranks "
                f"{sorted(set(range(self.world)) - set(got))} within "
                f"{self.timeout} s (a hung collective)")
        return [got[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        for p, q in zip(self._procs, self._ins):
            if p.is_alive() and not kill:
                q.put(None)
        for p in self._procs:
            p.join(5 if not kill else 0.1)
            if p.is_alive():
                p.kill()
                p.join()


# ---------------------------------------------------------------------------
# jobs (run in every rank)
# ---------------------------------------------------------------------------

def _np(t):
    import torch

    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return t


def train_job(zip_path, mesh, axes, batches, steps=2, scan=None,
              trainer_kwargs=None, ring=None, sp_mode=None, graph=False,
              masks=None, return_params=False, return_shards=False,
              trace=False):
    """Restore ``zip_path`` on the CPU, wrap it in a ParallelTrainer
    over ``mesh`` (a dict) with ``axes`` (trainer axis kwargs), and fit
    ``steps`` times on each of ``batches`` ((features, labels) global
    numpy pairs; cycled). ``ring`` sets every attention/recurrent bean's
    ``ring_axis`` (and ``sp_mode``). ``scan``: a (features, labels)
    stacked pair for one ``fit_scan`` window after the fits. Returns
    {"scores": [...], "params": whole params (rank 0 asks), ...}; with
    ``trace``, the args of the ``train.parallel_step`` spans a Tracer
    took."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet,
        MultiDataSet,
    )
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    net = restore_model(zip_path, device="cpu")
    if ring is not None:
        beans = ([v.conf.layer for v in net._layer_vertices.values()]
                 if graph else [c.layer for c in net.conf.confs])
        for lc in beans:
            if hasattr(lc, "ring_axis") and type(lc).__name__ in (
                    "MultiHeadSelfAttention", "TransformerBlock",
                    "GravesLSTM", "GRU"):
                lc.ring_axis = ring
                if sp_mode and hasattr(lc, "sp_mode"):
                    lc.sp_mode = sp_mode
    tracer = None
    if trace:
        from deeplearning4j_tpu_torch.profiler.tracer import Tracer

        tracer = Tracer()
    tr = ParallelTrainer(net, make_mesh(mesh), **axes, tracer=tracer,
                         **(trainer_kwargs or {}))
    scores = []
    for i in range(steps):
        x, y = batches[i % len(batches)]
        if graph:
            ds = MultiDataSet([x], [y])
        else:
            fm, lm = (None, None) if masks is None else masks
            ds = DataSet(x, y, fm, lm)
        scores.append(float(tr.fit(ds)))
    out = {"scores": scores}
    if scan is not None:
        out["scan"] = [float(s) for s in tr.fit_scan(*scan)]
    if trace:
        out["spans"] = [e["args"] for e in tracer.spans("train.parallel_step")]
    if return_params:
        out["params"] = _np(tr.full_params())
    if return_shards:
        out["shards"] = _np(net.params)
        out["upd"] = _np(net.updater_state)
        out["specs"] = {k: {n: tuple(s) for n, s in v.items()}
                        for k, v in tr.param_specs().items()}
    return out


def ep_job(params, x, capacity_factor, aux_weight, steps, lr=0.01):
    """``make_ep_moe`` over an {"ep": world} mesh: this rank's rows of
    the global tokens ``x`` and its slice of the experts of ``params``
    (numpy), ``steps`` SGD steps of mean(y²) + aux_weight·aux (the
    router's gradient summed over the ranks). Returns the global losses
    after each step."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.collectives import (
        count_weighted_mean,
        reduce_tensors,
    )
    from deeplearning4j_tpu_torch.parallel.expert_parallel import (
        make_ep_moe,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    n, r = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh({"ep": n})
    fn = make_ep_moe(mesh, "ep", capacity_factor=capacity_factor)
    e = params["W_up"].shape[0] // n
    p = {"router": torch.tensor(params["router"]),
         "W_up": torch.tensor(params["W_up"][r * e:(r + 1) * e]),
         "W_down": torch.tensor(params["W_down"][r * e:(r + 1) * e])}
    rows = x.shape[0] // n
    xl = torch.tensor(x[r * rows:(r + 1) * rows])
    losses = []
    for _ in range(steps):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y, aux = fn(leaves, xl)
        loss = (count_weighted_mean((y ** 2).mean(), y.numel(), x.size)
                + aux_weight * aux / n)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        grads["router"], = reduce_tensors([grads["router"]], None
                                          if n == 1 else dist.group.WORLD)
        lv, = reduce_tensors([loss.detach().clone()], dist.group.WORLD)
        losses.append(float(lv))
        p = {k: p[k] - lr * grads[k] for k in names}
    return {"losses": losses}


def checkpoint_job(zip_path, mesh, axes, batch, steps, directory,
                   restore_mesh=None, restore_axes=None):
    """Train through a ParallelTrainer, save with ``OrbaxCheckpointer``
    (every rank), and return the whole params; with ``restore_mesh``,
    also restore the checkpoint into a fresh trainer over that mesh and
    return its whole params."""
    from deeplearning4j_tpu_torch.checkpoint.orbax_io import (
        OrbaxCheckpointer,
    )
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    tr = ParallelTrainer(restore_model(zip_path, device="cpu"),
                         make_mesh(mesh), **axes)
    for _ in range(steps):
        tr.fit(DataSet(*batch))
    ck = OrbaxCheckpointer(directory, max_to_keep=2)
    ck.save(tr.net.iteration, tr)
    out = {"params": _np(tr.full_params()),
           "upd": _np(tr.full_updater_state()), "step": tr.net.iteration}
    if restore_mesh is not None:
        tr2 = ParallelTrainer(restore_model(zip_path, device="cpu"),
                              make_mesh(restore_mesh), **restore_axes)
        ck.restore_into(tr2)
        out["restored"] = _np(tr2.full_params())
        out["iteration"] = tr2.net.iteration
    return out


def early_stopping_job(zip_path, train, test, epochs, mesh):
    """``ParallelEarlyStoppingTrainer`` over a ParallelTrainer on
    ``mesh``: ``train`` a list of global (x, y) batches, ``test`` one
    (x, y); returns (epochs run, best epoch, score by epoch)."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    cfg = (es.EarlyStoppingConfiguration.Builder()
           .score_calculator(es.DataSetLossCalculator(
               ListDataSetIterator([DataSet(*test)])))
           .epoch_termination_conditions(
               es.MaxEpochsTerminationCondition(epochs))
           .model_saver(es.InMemoryModelSaver()).build())
    tr = ParallelTrainer(restore_model(zip_path, device="cpu"),
                         make_mesh(mesh))
    res = es.ParallelEarlyStoppingTrainer(
        cfg, tr, ListDataSetIterator([DataSet(*b) for b in train])).fit()
    return (res.total_epochs, res.best_model_epoch,
            dict(res.score_vs_epoch))
