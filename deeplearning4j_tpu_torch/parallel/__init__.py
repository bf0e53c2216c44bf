"""Parallelism over a ``torch.distributed`` mesh (port of
``deeplearning4j_tpu/parallel``): ``mesh`` (``MeshSpec``,
``make_mesh``), ``multihost`` (joining the process group),
``collectives`` (the autograd collectives and the step's
``ParallelScope``), ``data_parallel`` (``ParallelTrainer``: dp, tp,
fsdp, ep, sp and local-step averaging), ``sequence_parallel`` (ring and
Ulysses attention, ``sp_scan``), ``expert_parallel`` (capacity-routed
MoE and its all-to-all schedule) and ``dryrun`` (the multi-rank combo
check). Pipeline parallelism is a later slice (ROADMAP Queue 1 item
11b)."""

_LAZY = {"MeshSpec": "mesh", "make_mesh": "mesh",
         "ParallelTrainer": "data_parallel"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(name)
