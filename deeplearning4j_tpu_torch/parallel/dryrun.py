"""The multi-rank dry run: every data-parallel combo of the JAX
package's ``__graft_entry__.py:dryrun_multichip`` on n ranks of the port.

``dryrun_multichip(n, device="cuda", backend=None)`` spawns n ranks (one
process each, joined to one group on a free localhost port: NCCL on the
cards, one card a rank, unless ``backend`` says otherwise; gloo where the
caller passes ``device="cpu"``), runs the twelve
combos below for two or three steps each, and holds each trajectory
against an identically built single-process baseline with the JAX dry
run's tolerances (``TOL_F32 = 5e-3`` times max(1, |baseline|) on the
losses; the params of ``dp_local_avg`` at 1e-4 against a per-shard
emulation). Rank 0 prints the JAX dry run's lines, ``name=loss
d=delta/limit PASS|FAIL``, names the pipeline combos as not yet ported
(they are not counted), and returns {name: (loss, delta, limit,
status)}; a FAIL raises.

Combos (n divisible by 4): ``dp_tp`` (an MLP over dp x tp), ``dp_tp_scan``
(its ``fit_scan``), ``dp_local_avg`` (K=2 local steps then averaging),
``dp_fsdp``, ``sp`` (ring attention over n ranks against a ring of
one), ``dp_sp_conf`` and ``graph_dp_sp`` (a transformer and a graph
with ring attention over dp x sp), ``dp_sp_tp``, ``dp_tp_fsdp``, ``ep``
(``make_ep_moe``'s all-to-all dispatch against one rank, at a capacity
that drops nothing and no aux loss), ``ep_dropping`` (capacity 2.0 and
the aux loss, against the shard-local routing it defines) and
``ep_conf`` (a MoE transformer through ``ParallelTrainer(ep_axis=)``).
"""

from __future__ import annotations

import socket
import sys
import traceback

import numpy as np

TOL_F32 = 5e-3

#: the JAX dry run's pipeline combos: a later slice
PIPELINE_COMBOS = ("pp", "dp_pp", "dp_pp_scan", "dp_pp_tp",
                   "dp_pp_tp_interleaved", "pp_sp_tp")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flagship_net(hidden: int, device):
    from deeplearning4j_tpu_torch.nn.conf import (
        NeuralNetConfiguration,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    conf = (NeuralNetConfiguration.Builder().seed(12345).learning_rate(0.1)
            .updater(Updater.NESTEROVS).momentum(0.9).list()
            .layer(0, L.DenseLayer(n_in=784, n_out=hidden,
                                   activation="relu"))
            .layer(1, L.DenseLayer(n_in=hidden, n_out=hidden,
                                   activation="relu"))
            .layer(2, L.OutputLayer(n_in=hidden, n_out=10,
                                    activation="softmax",
                                    loss_function=LossFunction.MCXENT))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def _tnet(device, ring_axis=None):
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(transformer_lm(
        n_in=8, width=16, n_layers=2, n_heads=2, n_classes=8, lr=1e-2,
        ring_axis=ring_axis), device=device).init()


def _gnet(device, ring_axis=None):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        MultiHeadSelfAttention,
    )
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    gconf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.02)
             .graph_builder()
             .add_inputs("in")
             .add_layer("attn", MultiHeadSelfAttention(
                 n_in=8, n_out=8, n_heads=2, causal=True,
                 ring_axis=ring_axis), "in")
             .add_layer("out", L.RnnOutputLayer(
                 n_in=8, n_out=8, activation="softmax",
                 loss_function=LossFunction.MCXENT), "attn")
             .set_outputs("out").build())
    return ComputationGraph(gconf, device=device).init()


def _mnet(device, ep):
    from deeplearning4j_tpu_torch.models.zoo import moe_transformer_lm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(moe_transformer_lm(
        n_in=8, width=8, n_blocks=1, n_heads=2, n_classes=4,
        n_experts=ep, n_hidden=16, lr=1e-2), device=device).init()


def _one_hot_seq(rng, n, c, t):
    y = np.zeros((n, c, t), np.float32)
    ids = rng.integers(0, c, (n, t))
    for i in range(n):
        y[i, ids[i], np.arange(t)] = 1.0
    return y


def run_combos(n: int, device) -> dict:
    """Every combo on this rank (all ranks call it); rank 0's results."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet,
        MultiDataSet,
    )
    from deeplearning4j_tpu_torch.parallel.collectives import (
        AxisGroup,
        count_weighted_mean,
        reduce_tensors,
    )
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.expert_parallel import (
        init_moe_params,
        make_ep_moe,
        moe_apply,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import (
        MeshSpec,
        axis_group,
        make_mesh,
        mesh_coordinate,
        mesh_shape,
    )
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        make_ring_attention,
        ring_attention,
    )

    me = dist.get_rank()
    dtype = "cuda" if torch.device(device).type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    results = {}

    def record(name, par, base, tol=TOL_F32):
        par = [float(v) for v in np.atleast_1d(np.asarray(par))]
        if not all(np.isfinite(v) for v in par):
            raise AssertionError(f"non-finite {name}: {par}")
        base = [float(v) for v in np.atleast_1d(np.asarray(base))]
        if len(par) != len(base):
            raise AssertionError(f"{name}: trajectory lengths differ "
                                 f"({len(par)} vs {len(base)})")
        delta = max(abs(a - b) for a, b in zip(par, base))
        scale = max(1.0, max(abs(b) for b in base))
        ok = delta <= tol * scale
        results[name] = (par[-1], delta, tol * scale,
                         "PASS" if ok else "FAIL")

    def straj(net, ds, k=2):
        out = []
        for _ in range(k):
            net.fit(ds)
            out.append(float(net.score_value))
        return out

    def ptraj(trainer, ds, k=2):
        return [float(trainer.fit(ds)) for _ in range(k)]

    def mesh_of(spec):
        return make_mesh(MeshSpec(spec), device_type=dtype)

    # ---- dp + tp: an MLP's full train step --------------------------
    mesh = mesh_of({"dp": -1, "tp": 2})
    dp_n = mesh_shape(mesh)["dp"]
    net, bnet = _flagship_net(64, device), _flagship_net(64, device)
    trainer = ParallelTrainer(net, mesh, dp_axis="dp", tp_axis="tp")
    b = dp_n * 2
    x = rng.normal(size=(b, 784)).astype(np.float32)
    y = np.zeros((b, 10), np.float32)
    y[np.arange(b), rng.integers(0, 10, b)] = 1.0
    ds = DataSet(x, y)
    record("dp_tp", ptraj(trainer, ds), straj(bnet, ds))
    record("dp_tp_scan",
           trainer.fit_scan(np.stack([x, x]), np.stack([y, y])).tolist(),
           straj(bnet, ds))

    # ---- K local steps then average: params against per-shard nets --
    net2 = _flagship_net(32, device)
    trainer2 = ParallelTrainer(net2, mesh, dp_axis="dp", tp_axis=None,
                               average_each_iteration=False, local_steps=2)
    lavg = float(trainer2.fit(ds))
    rows = b // dp_n
    shard_params = []
    for i in range(dp_n):
        enet = _flagship_net(32, device)
        sds = DataSet(x[i * rows:(i + 1) * rows], y[i * rows:(i + 1) * rows])
        enet.fit(sds)
        enet.fit(sds)
        shard_params.append(enet.params)
    pdelta = 0.0
    for key, sub in net2.params.items():
        for name, p in sub.items():
            avg = sum(sp[key][name].double() for sp in shard_params) / dp_n
            pdelta = max(pdelta, float((p.double() - avg).abs().max()))
    results["dp_local_avg"] = (lavg, pdelta, 1e-4,
                               "PASS" if pdelta <= 1e-4 else "FAIL")

    # ---- dp x fsdp ----------------------------------------------------
    fmesh = mesh_of({"dp": 2, "fsdp": -1})
    fnet, fbnet = _flagship_net(32, device), _flagship_net(32, device)
    ftrainer = ParallelTrainer(fnet, fmesh, fsdp_axis="fsdp")
    record("dp_fsdp", ptraj(ftrainer, ds), straj(fbnet, ds))
    if "fsdp" not in ftrainer.param_specs()["0"]["W"]:
        raise AssertionError("fsdp not applied")

    # ---- sp: ring attention over n ranks against a ring of one ------
    srng = np.random.default_rng(2)
    t, dh = n * 4, 8
    wq0 = (srng.normal(size=(dh, dh)) * 0.3).astype(np.float32)
    xs0 = srng.normal(size=(2, 2, t, dh)).astype(np.float32)
    smesh = mesh_of({"sp": n})
    sp_group = axis_group(smesh, "sp")
    sp_idx = mesh_coordinate(smesh)["sp"]

    def sp_losses(ring, xs, group, total, k=2):
        wq = torch.tensor(wq0, device=device)
        xs = torch.tensor(xs, device=device)
        out = []
        for _ in range(k):
            w = wq.clone().requires_grad_(True)
            q = torch.einsum("bhtd,de->bhte", xs, w)
            loss = count_weighted_mean(
                (ring(q, xs, xs) ** 2).mean(), xs.numel(), total)
            g, = torch.autograd.grad(loss, w)
            g, = reduce_tensors([g], group)
            lv, = reduce_tensors([loss.detach().clone()], group)
            wq = wq - 0.01 * g
            out.append(float(lv))
        return out

    chunk = xs0[:, :, sp_idx * (t // n):(sp_idx + 1) * (t // n)]
    one = AxisGroup("sp", None, 1, 0)
    record("sp", sp_losses(make_ring_attention(smesh, "sp"), chunk,
                           sp_group, xs0.size),
           sp_losses(lambda q, k, v: ring_attention(q, k, v, one), xs0,
                     None, xs0.size))

    # ---- dp x sp (conf level), graph dp x sp, dp x sp x tp ----------
    tr = np.random.default_rng(7)
    xs_c = tr.normal(size=(4, 8, 16)).astype(np.float32)
    cds = DataSet(xs_c, _one_hot_seq(tr, 4, 8, 16))
    spmesh = mesh_of({"dp": 2, "sp": -1})
    record("dp_sp_conf",
           ptraj(ParallelTrainer(_tnet(device, "sp"), spmesh, sp_axis="sp"),
                 cds), straj(_tnet(device), cds))
    gds = MultiDataSet([cds.features], [cds.labels])
    record("graph_dp_sp",
           ptraj(ParallelTrainer(_gnet(device, "sp"), spmesh, sp_axis="sp"),
                 gds), straj(_gnet(device), gds))
    m3 = mesh_of({"dp": -1, "sp": 2, "tp": 2})
    record("dp_sp_tp",
           ptraj(ParallelTrainer(_tnet(device, "sp"), m3, sp_axis="sp",
                                 tp_axis="tp"), cds),
           straj(_tnet(device), cds))

    # ---- dp x tp x fsdp on the transformer ---------------------------
    mesh3 = mesh_of({"dp": -1, "tp": 2, "fsdp": 2})
    record("dp_tp_fsdp",
           ptraj(ParallelTrainer(_tnet(device), mesh3, tp_axis="tp",
                                 fsdp_axis="fsdp"), cds),
           straj(_tnet(device), cds))

    # ---- ep: the all-to-all dispatch ---------------------------------
    ep = min(4, n)
    edp = max(1, n // ep)
    erng = np.random.default_rng(3)
    ex0 = erng.normal(size=(edp * ep * 4, 8)).astype(np.float32)
    emesh = mesh_of({"dp": edp, "ep": ep})
    tok_group = axis_group(emesh, ("dp", "ep"))
    ecoord = mesh_coordinate(emesh)
    tok_idx = ecoord["dp"] * ep + ecoord["ep"]
    gen = torch.Generator(device=device).manual_seed(0)
    full = init_moe_params(gen, ep, 8, 16, device=device)
    e0, e1 = ecoord["ep"], ecoord["ep"] + 1
    local = {"router": full["router"], "W_up": full["W_up"][e0:e1],
             "W_down": full["W_down"][e0:e1]}
    n_tok = edp * ep
    x_local = ex0.reshape(n_tok, -1, 8)[tok_idx]

    def ep_losses(fn, params, xe, group, total, k=2, aux_weight=0.0):
        params = {kk: v.clone() for kk, v in params.items()}
        xe = torch.tensor(xe, device=device)
        out = []
        for _ in range(k):
            leaves = {kk: v.clone().requires_grad_(True)
                      for kk, v in params.items()}
            y_, aux = fn(leaves, xe)
            share = count_weighted_mean((y_ ** 2).mean(), y_.numel(), total)
            loss = share + aux_weight * aux / (
                1 if group is None else dist.get_world_size(group))
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[nm] for nm in names])
            grads = dict(zip(names, grads))
            # the router is whole on every rank: its gradient sums over
            # the token ranks; each expert's arrives whole through the
            # return all-to-all
            grads["router"], = reduce_tensors([grads["router"]], group)
            lv, = reduce_tensors([loss.detach().clone()], group)
            params = {kk: params[kk] - 0.01 * grads[kk] for kk in names}
            out.append(float(lv))
        return out

    numel = ex0.size
    record("ep",
           ep_losses(make_ep_moe(emesh, "ep", token_axes=("dp", "ep"),
                                 capacity_factor=4.0), local, x_local,
                     tok_group, numel),
           ep_losses(lambda p, xx: moe_apply(p, xx, 4.0), full, ex0, None,
                     numel))
    # capacity 2 drops tokens per rank (GShard: routing and the aux loss
    # are shard-local), so the baseline routes each rank's tokens apart
    par = ep_losses(make_ep_moe(emesh, "ep", token_axes=("dp", "ep"),
                                capacity_factor=2.0), local, x_local,
                    tok_group, numel, k=1, aux_weight=0.01)
    base = 0.0
    for s in range(n_tok):
        yy, aux = moe_apply(full, torch.tensor(ex0.reshape(n_tok, -1, 8)[s],
                                               device=device), 2.0)
        base += float((yy ** 2).mean() + 0.01 * aux) / n_tok
    record("ep_dropping", par, [base])

    # ---- ep (conf level): MoE transformer, experts over ep ----------
    mrng = np.random.default_rng(4)
    bm, tm = edp * 2, 4
    xm = mrng.normal(size=(bm, 8, tm)).astype(np.float32)
    mds = DataSet(xm, _one_hot_seq(mrng, bm, 4, tm))
    record("ep_conf",
           ptraj(ParallelTrainer(_mnet(device, ep), emesh, ep_axis="ep"),
                 mds), straj(_mnet(device, ep), mds))
    return results if me == 0 else None


def _rank_main(rank, n, port, device, backend, queue):
    try:
        import torch

        torch.set_num_threads(1)
        from deeplearning4j_tpu_torch.parallel.multihost import (
            initialize_multihost,
            shutdown_multihost,
        )

        initialize_multihost(f"tcp://127.0.0.1:{port}", n, rank,
                             backend=backend, device=device)
        dev = device
        if str(device).startswith("cuda"):
            dev = f"cuda:{torch.cuda.current_device()}"
        try:
            res = run_combos(n, dev)
        finally:
            shutdown_multihost()
        queue.put((rank, True, res))
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, False, traceback.format_exc()))


def dryrun_multichip(n: int, device: str = "cuda", backend=None,
                     timeout: float = 600.0) -> dict:
    """Spawn ``n`` ranks, run every combo, print rank 0's lines and
    return its results; raises if a rank fails or a combo FAILs.

    ``device="cuda"`` (the default) binds rank r to card r under NCCL,
    which raises where the host has fewer cards than ranks;
    ``device="cpu"`` runs the ranks under gloo on the CPU."""
    import multiprocessing as mp

    if n % 4:
        raise ValueError(f"the dry run's meshes need n divisible by 4, got "
                         f"{n}")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, device, backend, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    answers = {}
    try:
        for _ in range(n):
            rank, ok, res = queue.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"dry run rank {rank} failed:\n{res}")
            answers[rank] = res
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    results = answers[0]
    lines, failures = [], []
    for k, (v, delta, tol, status) in results.items():
        lines.append(f"{k}={v:.4f} d={delta:.2e}/{tol:.0e} {status}")
        if status == "FAIL":
            failures.append(k)
    print("dryrun numerics vs single-device baseline:")
    for line in lines:
        print("  " + line)
    for k in PIPELINE_COMBOS:
        print(f"  {k}: not yet ported (pipeline parallelism, ROADMAP "
              "Queue 1 item 11b)")
    if failures:
        raise AssertionError(
            f"multi-rank numerics diverge from single-device: {failures}")
    print(f"dryrun_multichip OK: {len(results)} combos, "
          f"{sum(1 for r in results.values() if r[3] == 'PASS')} "
          "trajectory-checked PASS")
    return results


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run the data-parallel combos on n ranks against a "
                    "single-process baseline.")
    ap.add_argument("n", type=int, nargs="?", default=4,
                    help="number of ranks (divisible by 4)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one card a rank under NCCL (default); "
                         "cpu: gloo ranks on the CPU")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend (default: from "
                         "--device)")
    args = ap.parse_args(argv)
    return 0 if dryrun_multichip(args.n, device=args.device,
                                 backend=args.backend) else 1


if __name__ == "__main__":
    sys.exit(main())
