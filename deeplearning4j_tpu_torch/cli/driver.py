"""The command line: ``python -m deeplearning4j_tpu_torch.cli
train|test|predict|serve|route|fleet|client``.

The subcommands of ``deeplearning4j_tpu/cli/driver.py`` but ``worker``
(which comes with scale-out, ROADMAP item 11). Every one that builds or
loads a net takes ``--device`` (default ``cuda``; ``cpu`` on a host
without a card).

- ``train`` builds a net from a conf JSON (the model-config-is-the-wire-
  format property) or a properties file, fits it on the input and saves
  a model zip (the JAX package's format); ``test`` evaluates a zip and
  prints ``Evaluation.stats()``; ``predict`` writes argmax classes, or
  the probabilities with ``--raw``, as CSV (reference
  deeplearning4j-cli Train/Test/Predict). Inputs: ``mnist``,
  ``mnist-test``, ``iris``, a numeric CSV (last column the integer
  class) or an ``.npz`` with ``features`` [+ ``labels``].
- ``serve`` loads an LM-shaped model zip (either package's
  ``write_model``) and runs the streaming HTTP gateway over it
  (serving/gateway.py): blocking and SSE generation, cancel, metrics,
  drain to a snapshot on shutdown, restore on boot when the snapshot
  exists. ``route`` fronts running gateways (either package's) with the
  failure-tolerant prefix-affinity router (serving/router.py); ``fleet``
  spawns N ``serve`` children on the same ``--device``, the router over
  them and the SLO-driven fleet controller (serving/controller.py).
  ``client`` sends one generation to any of them (``GatewayClient``).

The parsers are JAX's: ``--tenant`` (repeatable, ``TenantSpec.parse``'s
spelling) turns on the weighted-fair scheduler, ``--kv-host-tier-bytes``,
``--kv-disk-tier-path`` and ``--kv-disk-tier-bytes`` the KV spill tiers.
``train --mesh 'dp=2,tp=2'`` trains through ``ParallelTrainer`` under a
launcher (``torchrun --nproc-per-node N -m deeplearning4j_tpu_torch.cli
train ...``, or ``python -m torch.distributed.run``): every rank trains,
rank 0 writes the model. Without a launcher's environment only a mesh
of size 1 runs; a larger one exits saying how to launch. The flags of
the knobs the port does not carry yet (``serve --tp``, a ``pp`` mesh
axis and ``--pp-interleave``) are parsed, and a value exits with a
message naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Tuple

import numpy as np

#: --use-flash-paged CLI spelling -> DecodeEngine toggle value (JAX's
#: "interpret", the Pallas interpreter, has no counterpart here)
FLASH_PAGED_MODES = {"auto": None, "on": True, "off": False}

#: flags of knobs the port refuses: (attribute, default, ROADMAP item)
UNPORTED_FLAGS = (
    ("tp", 1, "11c (tensor-parallel serving)"),
    ("pp_interleave", None, "11b (pipeline parallel training)"),
)


def refuse_unported(args) -> None:
    """Exit (``SystemExit`` with a message) when a flag of a knob the
    port does not carry is set to anything but its default."""
    for attr, default, item in UNPORTED_FLAGS:
        value = getattr(args, attr, default)
        if value != default:
            flag = "--" + attr.replace("_", "-")
            raise SystemExit(
                f"{flag} {value!r}: not ported to the torch package yet "
                f"(ROADMAP item {item})")


# ---------------------------------------------------------------------------
# input resolution (the FileScheme / RecordReader role)
# ---------------------------------------------------------------------------

def load_csv(path: str, num_classes: Optional[int] = None,
             label_column: int = -1) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Numeric CSV → (features, one-hot labels). ``label_column=None``
    (via --no-labels) means feature-only input for predict."""
    from deeplearning4j_tpu_torch.native_rt import read_csv

    data = read_csv(path)
    if label_column is None:
        return data.astype(np.float32), None
    labels_raw = data[:, label_column].astype(int)
    feats = np.delete(data, label_column % data.shape[1], axis=1)
    n_cls = num_classes or int(labels_raw.max()) + 1
    labels = np.eye(n_cls, dtype=np.float32)[labels_raw]
    return feats.astype(np.float32), labels


def resolve_input(uri: str, num_classes: Optional[int] = None,
                  with_labels: bool = True,
                  num_examples: Optional[int] = None):
    """URI/path → (features, labels|None)."""
    if uri == "iris":
        from deeplearning4j_tpu_torch.datasets.iris import iris_dataset

        ds = iris_dataset()
        return np.asarray(ds.features), np.asarray(ds.labels)
    if uri in ("mnist", "mnist-test"):
        from deeplearning4j_tpu_torch.datasets.mnist import mnist_dataset

        ds = mnist_dataset(train=(uri == "mnist"),
                           num_examples=num_examples)
        return np.asarray(ds.features), np.asarray(ds.labels)
    if not os.path.exists(uri):
        raise FileNotFoundError(f"input not found: {uri}")
    if uri.endswith(".npz"):
        arc = np.load(uri)
        feats = arc["features"].astype(np.float32)
        labels = arc["labels"].astype(np.float32) if (
            with_labels and "labels" in arc) else None
        return feats, labels
    return load_csv(uri, num_classes,
                    label_column=-1 if with_labels else None)


# ---------------------------------------------------------------------------
# conf resolution (JSON conf or java-style properties file)
# ---------------------------------------------------------------------------

def _conf_from_properties(path: str):
    """Minimal properties-file network spec (reference Train.java builds a
    conf from a properties file): keys ``layers`` (comma sizes, e.g.
    784,500,10), ``activation``, ``learning_rate``, ``updater``, ``seed``,
    ``iterations``, ``loss``."""
    props = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "!")):
                continue
            key, _, value = line.partition("=")
            props[key.strip()] = value.strip()

    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration, Updater
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    sizes = [int(s) for s in props["layers"].split(",")]
    if len(sizes) < 2:
        raise ValueError("properties 'layers' needs >=2 comma-separated sizes")
    builder = (NeuralNetConfiguration.Builder()
               .seed(int(props.get("seed", 12345)))
               .iterations(int(props.get("iterations", 1)))
               .learning_rate(float(props.get("learning_rate", 0.1)))
               .updater(Updater[props.get("updater", "SGD").upper()])
               .list())
    act = props.get("activation", "relu")
    loss = LossFunction[props.get("loss", "MCXENT").upper()]
    for i in range(len(sizes) - 2):
        builder.layer(i, L.DenseLayer(n_in=sizes[i], n_out=sizes[i + 1],
                                      activation=act))
    builder.layer(len(sizes) - 2,
                  L.OutputLayer(n_in=sizes[-2], n_out=sizes[-1],
                                activation="softmax", loss_function=loss))
    return builder.build()


def resolve_conf(path: str):
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import MultiLayerConfiguration

    if path.endswith((".properties", ".props")):
        return _conf_from_properties(path)
    with open(path) as f:
        return MultiLayerConfiguration.from_json(f.read())


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _cmd_train(args) -> int:
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import (
        ScoreIterationListener,
    )
    from deeplearning4j_tpu_torch.util.model_serializer import write_model

    refuse_unported(args)
    conf = resolve_conf(args.conf)
    net = MultiLayerNetwork(conf, device=args.device).init()
    if args.verbose:
        net.set_listeners(ScoreIterationListener(10))
    feats, labels = resolve_input(args.input, num_classes=args.num_classes,
                                  num_examples=args.num_examples)
    if labels is None:
        raise ValueError("training input must include labels")
    batch = args.batch_size or len(feats)
    sets = [DataSet(feats[i:i + batch], labels[i:i + batch])
            for i in range(0, len(feats), batch)]
    if args.mesh:
        return _train_on_mesh(args, net, sets, feats, labels, batch)
    for _ in range(args.epochs):
        net.fit(ListDataSetIterator(sets))
    write_model(net, args.output)
    score = net.score(DataSet(feats[:batch], labels[:batch]))
    print(f"saved model to {args.output} (final score {score:.6f})")
    return 0


def parse_mesh(text: str) -> dict:
    """``'dp=2,tp=2'`` -> {"dp": 2, "tp": 2}; exits on a bad spec, on
    a mesh without a dp axis, and on a pp axis (not ported)."""
    try:
        spec = {k.strip(): int(v) for k, v in
                (part.split("=") for part in text.split(","))}
    except ValueError:
        raise SystemExit(
            f"--mesh {text!r}: expected 'axis=N[,axis=N...]'")
    if "pp" in spec:
        raise SystemExit(
            f"--mesh {text!r}: pipeline parallelism (a pp axis) is not "
            "ported to the torch package yet (ROADMAP item 11b)")
    if "dp" not in spec:
        raise SystemExit(
            "--mesh must include a dp axis (the batch shards over it), "
            "e.g. 'dp=8' or 'dp=2,tp=4'")
    return spec


def _train_on_mesh(args, net, sets, feats, labels, batch) -> int:
    """``train --mesh``: every rank of the launcher's world trains the
    same net through ``ParallelTrainer`` on the same global batches
    (ragged tails trimmed so every data rank gets an equal slice); rank
    0 gathers the shards and writes the model."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel.data_parallel import (
        ParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from deeplearning4j_tpu_torch.parallel.multihost import (
        initialize_multihost,
        shutdown_multihost,
    )
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    import torch.distributed as dist

    spec = parse_mesh(args.mesh)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    sizes = MeshSpec(spec).resolve(world)
    total = int(np.prod(list(sizes.values())))
    if world == 1 and total != 1:
        raise SystemExit(
            f"--mesh {args.mesh!r} needs {total} ranks, one process per "
            f"device: launch it as `torchrun --nproc-per-node {total} -m "
            "deeplearning4j_tpu_torch.cli train ... --mesh "
            f"{args.mesh}` (or `python -m torch.distributed.run ...`)")
    if world == 1:
        from deeplearning4j_tpu_torch.serving.replica_proc import free_port

        initialize_multihost(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                             device=args.device)
    else:
        initialize_multihost(device=args.device)
    try:
        trainer = ParallelTrainer(
            net, make_mesh(MeshSpec(spec), device_type=net.device.type),
            tp_axis="tp" if "tp" in spec else None,
            fsdp_axis="fsdp" if "fsdp" in spec else None,
            ep_axis="ep" if "ep" in spec else None,
            sp_axis="sp" if "sp" in spec else None)
        div = sizes.get("dp", 1) * sizes.get("fsdp", 1)
        trimmed = [DataSet(ds.features[:len(ds.features) // div * div],
                           ds.labels[:len(ds.features) // div * div])
                   for ds in sets]
        trimmed = [ds for ds in trimmed if ds.features.shape[0] > 0]
        if not trimmed:
            raise SystemExit(
                f"--mesh {args.mesh!r}: every batch is smaller than the "
                f"{div} data shards; raise --batch-size")
        dropped = len(feats) - sum(ds.features.shape[0] for ds in trimmed)
        rank0 = dist.get_rank() == 0
        if dropped and rank0:
            print(f"note: dropped {dropped} ragged-tail examples so "
                  f"batches divide the {div} data shards")
        for _ in range(args.epochs):
            trainer.fit(ListDataSetIterator(trimmed))
        whole = trainer.unsharded_net()
        if rank0:
            write_model(whole, args.output)
            score = whole.score(DataSet(feats[:batch], labels[:batch]))
            print(f"saved model to {args.output} (final score "
                  f"{score:.6f}, mesh {sizes})")
    finally:
        shutdown_multihost()
    return 0


def _outputs(net, feats) -> np.ndarray:
    """The net's output on ``feats`` as float32 numpy on the host."""
    return net.output(feats).float().cpu().numpy()


def _cmd_test(args) -> int:
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    net = restore_model(args.model, device=args.device)
    feats, labels = resolve_input(args.input, num_classes=args.num_classes,
                                  num_examples=args.num_examples)
    if labels is None:
        raise ValueError("test input must include labels")
    ev = Evaluation()
    ev.eval(labels, _outputs(net, feats))
    print(ev.stats())
    return 0


def _cmd_predict(args) -> int:
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    net = restore_model(args.model, device=args.device)
    feats, _ = resolve_input(args.input, with_labels=args.has_labels,
                             num_examples=args.num_examples)
    if args.raw:
        rows = _outputs(net, feats)
        fmt = "%.8f"
    else:
        rows = net.predict(feats).reshape(-1, 1)
        fmt = "%d"
    if args.output == "-":
        np.savetxt(sys.stdout, rows, fmt=fmt, delimiter=",")
    else:
        np.savetxt(args.output, rows, fmt=fmt, delimiter=",")
        print(f"wrote {rows.shape[0]} predictions to {args.output}")
    return 0


def tenants_from_args(args):
    """The :class:`TenantRegistry` of the repeated ``--tenant`` specs
    (``name[:key=value]...``, see ``TenantSpec.parse``), or None when
    none was given (tenancy off: the FIFO scheduler)."""
    specs = getattr(args, "tenant", None) or []
    if not specs:
        return None
    from deeplearning4j_tpu_torch.serving import TenantRegistry, TenantSpec

    return TenantRegistry(tuple(TenantSpec.parse(s) for s in specs))


def gateway_from_args(args):
    """Build (or restore) the serving gateway the ``serve`` subcommand
    runs (JAX's ``gateway_from_args``), factored out so tests can drive
    the exact CLI path without the serve-forever loop. Restore on boot:
    when ``--snapshot`` names an existing drain snapshot, the engine
    resumes that state (same ids) instead of starting fresh."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine, ServingGateway
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model

    refuse_unported(args)
    tenants = tenants_from_args(args)
    device = getattr(args, "device", "cuda")
    flash = FLASH_PAGED_MODES[getattr(args, "use_flash_paged", "auto")]

    def load():
        return restore_model(args.model, device=device)

    def engine():
        return DecodeEngine(
            load(), n_slots=args.slots,
            decode_chunk=args.decode_chunk,
            prefix_cache_rows=args.prefix_cache_rows,
            prefill_chunk=args.prefill_chunk,
            admission_policy=args.admission_policy,
            max_queue=args.max_queue,
            paranoid=args.paranoid,
            spec_draft_len=args.spec_draft_len,
            paged_kv=args.paged_kv,
            block_tokens=args.block_tokens,
            kv_blocks=args.kv_blocks,
            use_flash_paged=flash,
            tenants=tenants,
            async_rounds=getattr(args, "async_rounds", False),
            fused_rounds=getattr(args, "fused_rounds", 0),
            kv_host_tier_bytes=getattr(args, "kv_host_tier_bytes", 0),
            kv_disk_tier_path=getattr(args, "kv_disk_tier_path", None),
            kv_disk_tier_bytes=getattr(args, "kv_disk_tier_bytes", None))

    return ServingGateway.boot(
        engine, snapshot_path=args.snapshot, net_factory=load,
        # the host's kernel toggle wins over the snapshot's, and so do
        # its --tenant specs (None: keep the snapshot's registry)
        restore_kwargs={"use_flash_paged": flash, "tenants": tenants},
        host=args.host, port=args.port,
        replica_id=getattr(args, "replica_id", None),
        role=getattr(args, "role", "any"))


def build_kernels_for(gw):
    """Build, before a replica reports ready, the kernel its engine
    runs on the card: K2 (``csrc/paged_attention.cu``) for a paged
    engine on a CUDA device whose kernel toggle is not off. A build
    that fails raises, so a ``serve`` child that cannot build K2 exits
    non-zero before its ``serving on`` line and a router sees a dead
    replica. Returns ``{source: seconds}`` (0.0 for a library built
    already), empty when the engine runs no kernel."""
    eng = gw.engine
    if (eng.device.type != "cuda" or not eng.paged_kv
            or eng.use_flash_paged is False):
        return {}
    from deeplearning4j_tpu_torch import cuda_build

    return cuda_build.build_all(["paged_attention"])


def _cmd_serve(args) -> int:
    import time as _time

    gw = gateway_from_args(args)
    for name, secs in build_kernels_for(gw).items():
        print(f"built {name} in {secs:.1f} s", flush=True)
    gw.start()
    # flush: a parent process reads this line through a pipe as the
    # boot handshake
    print(f"serving on {gw.address} "
          f"(POST /v1/generate, GET /v1/healthz, GET /v1/metrics)",
          flush=True)
    failed = False
    try:
        while gw._stepper.is_alive():
            _time.sleep(0.5)
        # the stepping thread died (a kernel that failed to launch, a
        # device fault): exit non-zero instead of serving a replica
        # whose requests never finish
        failed = True
        print("stepping thread ended: exiting", file=sys.stderr,
              flush=True)
    except KeyboardInterrupt:
        print("draining...")
    finally:
        if failed:
            gw.close()
        else:
            summary = gw.drain(timeout_s=args.drain_timeout)
            gw.close()
            if summary["snapshot"]:
                print(f"snapshot ({summary['carried']} in-flight "
                      f"requests) -> {summary['snapshot']}")
    return 1 if failed else 0

def router_from_args(args):
    """Build the multi-replica serving router the ``route``
    subcommand runs (JAX's ``router_from_args``), factored out so tests
    can drive the exact CLI path without the serve-forever loop."""
    from deeplearning4j_tpu_torch.serving import ServingRouter

    replicas = [a.strip() for a in args.replicas.split(",")
                if a.strip()]
    return ServingRouter(
        replicas, host=args.host, port=args.port,
        affinity_block_tokens=args.affinity_block_tokens,
        health_interval_s=args.health_interval,
        failure_threshold=args.failure_threshold,
        probe_interval_s=args.probe_interval,
        max_replays=args.max_replays,
        tenants=tenants_from_args(args),
        journal_path=getattr(args, "journal_path", None),
        fsync=getattr(args, "fsync", "batched"))


def _cmd_route(args) -> int:
    import time as _time

    router = router_from_args(args).start()
    wal = ""
    if getattr(args, "journal_path", None):
        wal = (f", WAL {args.journal_path} "
               f"(fsync={args.fsync}, recovered "
               f"{router.stats['recovered_entries']} entries, "
               f"{router.stats['recovered_open']} open)")
    print(f"routing on {router.address} over "
          f"{len(router._replicas)} replicas "
          f"(POST /v1/generate, GET /v1/healthz, GET /v1/metrics, "
          f"POST /v1/replicas/drain){wal}", flush=True)
    try:
        while True:
            _time.sleep(0.5)
    except KeyboardInterrupt:
        print("stopping router (replicas keep serving)...")
    finally:
        router.close()
    return 0


def _serve_child_argv(args, port: int, replica_id: str):
    """Child argv for one fleet replica: this package's ``serve``
    subcommand on an ephemeral port with a stable replica id, on the
    fleet's ``--device``."""
    argv = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
            "serve", "--model", args.model,
            "--device", getattr(args, "device", "cuda"),
            "--host", "127.0.0.1", "--port", str(port),
            "--replica-id", replica_id,
            "--slots", str(args.slots),
            "--decode-chunk", str(args.decode_chunk),
            "--prefix-cache-rows", str(args.prefix_cache_rows),
            "--prefill-chunk", str(args.prefill_chunk),
            "--admission-policy", args.admission_policy]
    if args.paged_kv:
        argv += ["--paged-kv", "--block-tokens",
                 str(args.block_tokens)]
        if args.kv_blocks is not None:
            argv += ["--kv-blocks", str(args.kv_blocks)]
        if getattr(args, "kv_host_tier_bytes", 0):
            argv += ["--kv-host-tier-bytes",
                     str(args.kv_host_tier_bytes)]
        if getattr(args, "kv_disk_tier_path", None):
            # per-replica subdirectory: ring files are engine-local
            argv += ["--kv-disk-tier-path",
                     os.path.join(args.kv_disk_tier_path,
                                  replica_id)]
            if getattr(args, "kv_disk_tier_bytes", None) is not None:
                argv += ["--kv-disk-tier-bytes",
                         str(args.kv_disk_tier_bytes)]
    if getattr(args, "tp", 1) != 1:
        argv += ["--tp", str(args.tp)]
    if getattr(args, "use_flash_paged", "auto") != "auto":
        argv += ["--use-flash-paged", args.use_flash_paged]
    if getattr(args, "async_rounds", False):
        argv += ["--async-rounds"]
    if getattr(args, "fused_rounds", 0):
        argv += ["--fused-rounds", str(args.fused_rounds)]
    for spec in getattr(args, "tenant", None) or []:
        # every replica enforces the same tenant table the router
        # rate-limits by — quotas and priorities are fleet-wide
        argv += ["--tenant", spec]
    return argv


def fleet_from_args(args):
    """Build the elastic fleet the ``fleet`` subcommand runs (JAX's
    ``fleet_from_args``) — N subprocess ``serve`` replicas, the
    failure-tolerant router over them, and the SLO-driven
    :class:`FleetController` that breathes the fleet (spawns replicas
    on pressure/TTFT-SLO violations, drains idle ones,
    `controller.rolling_upgrade()` for zero-downtime model upgrades).
    Factored out so tests can drive the exact CLI wiring without the
    serve-forever loop. Returns ``(replicas, router, controller)`` —
    none of them started. A flag the port does not carry exits
    before any child is spawned."""
    from deeplearning4j_tpu_torch.serving import (
        FleetController,
        ServingRouter,
    )
    from deeplearning4j_tpu_torch.serving.replica_proc import (
        ReplicaProcess,
        free_port,
        shutdown_all,
    )

    refuse_unported(args)

    def spawn(replica_id: str):
        port = free_port()
        return ReplicaProcess(
            _serve_child_argv(args, port, replica_id),
            replica_id=replica_id, port=port,
            ready_pattern="serving on")

    def factory(replica_id: str):
        proc = spawn(replica_id)
        try:
            proc.wait_ready(timeout_s=300.0)
        except BaseException:
            proc.shutdown()  # a wedged boot must not leak the child
            raise
        return proc

    # spawn all seeds first so their device inits overlap, then wait;
    # ANY failure before the caller owns the fleet (a wedged boot, a
    # bad router port, rejected controller bounds) must reap every
    # child already spawned — orphaned serve subprocesses outlive
    # the CLI (and hold the card)
    seeds = [spawn(f"fleet-{i}") for i in range(args.replicas)]
    try:
        for r in seeds:
            r.wait_ready(timeout_s=300.0)
        router = ServingRouter(
            [r.address for r in seeds], host=args.host,
            port=args.port,
            affinity_block_tokens=args.affinity_block_tokens,
            tenants=tenants_from_args(args))
        controller = FleetController(
            router, replica_factory=factory,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            eval_interval_s=args.eval_interval,
            ttft_p99_slo_s=args.ttft_slo,
            pressure_high=args.pressure_high,
            pressure_low=args.pressure_low,
            cooldown_s=args.cooldown, id_prefix="fleet-auto")
    except BaseException:
        shutdown_all(seeds)
        raise
    for r in seeds:
        controller.adopt(r)
    return seeds, router, controller


def _cmd_fleet(args) -> int:
    import time as _time

    print(f"booting {args.replicas} replica(s)...", flush=True)
    seeds, router, controller = fleet_from_args(args)
    try:
        router.start()
        controller.start()
        print(f"fleet routing on {router.address} over "
              f"{len(seeds)} replicas, controller live "
              f"(min {controller.min_replicas} / max "
              f"{controller.max_replicas}, TTFT-p99 SLO "
              f"{controller.ttft_p99_slo_s}); scale timeline at "
              f"GET /v1/trace as fleet.scale spans", flush=True)
        try:
            while True:
                _time.sleep(0.5)
        except KeyboardInterrupt:
            print("stopping fleet (drain + reap)...")
    finally:
        controller.close()
        router.close()
        # the seeds were adopted, so shutdown_fleet reaps everything
        controller.shutdown_fleet()
    return 0


def _cmd_client(args) -> int:
    """One generation against a running gateway or router
    (the ``client`` subcommand): the smallest way to exercise a serving
    deployment — including its tenancy surface (``--tenant`` /
    ``--priority`` ride the request; a 429 prints that tenant's own
    Retry-After instead of dying with a traceback)."""
    from deeplearning4j_tpu_torch.serving import GatewayClient, GatewayError

    try:
        prompt = [int(t) for t in args.prompt.split(",") if t.strip()]
    except ValueError:
        raise SystemExit(
            f"--prompt {args.prompt!r}: expected comma-separated "
            "token ids, e.g. '1,4,7,2'")
    if not prompt:
        raise SystemExit("--prompt must carry at least one token id")
    kwargs = {}
    if args.tenant is not None:
        kwargs["tenant"] = args.tenant
    if args.priority is not None:
        kwargs["priority"] = args.priority
    if args.temperature:
        kwargs["temperature"] = args.temperature
    client = GatewayClient(args.address, timeout_s=args.timeout)
    try:
        if args.stream:
            stream = client.stream(prompt, args.max_new_tokens,
                                   **kwargs)
            tokens = []
            for delta in stream:
                tokens.extend(delta)
                print(f"delta: {delta}", flush=True)
            result = stream.result or {}
        else:
            result = client.generate(prompt, args.max_new_tokens,
                                     **kwargs)
            tokens = result.get("tokens", [])
    except GatewayError as e:
        if e.status == 429:
            tenant = e.payload.get("tenant")
            print(f"429 throttled"
                  + (f" (tenant {tenant})" if tenant else "")
                  + f": retry after {e.retry_after_s}s "
                  f"({e.payload.get('error')})")
            return 2
        raise SystemExit(f"request failed: {e}")
    print(f"tokens: {tokens}")
    print(f"finish_reason: {result.get('finish_reason')}"
          + (f" tenant: {result['tenant']}"
             if result.get("tenant") else ""))
    return 0 if result.get("finish_reason") in ("length", "eos") \
        else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.cli",
        description="Train, test and predict with "
                    "deeplearning4j_tpu_torch models, and serve them: "
                    "one gateway, a router over gateways, or an "
                    "elastic fleet (the JAX package's CLI but "
                    "worker).")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, model_in: bool):
        sp.add_argument("--input", required=True,
                        help="data source: mnist | mnist-test | iris | "
                             "path.csv | path.npz")
        sp.add_argument("--num-classes", type=int, default=None)
        sp.add_argument("--num-examples", type=int, default=None,
                        help="cap examples loaded from built-in datasets")
        sp.add_argument("--device", default="cuda",
                        help="torch device the net runs on (default "
                             "cuda; cpu for a card-less host)")
        if model_in:
            sp.add_argument("--model", required=True,
                            help="model zip from train (either "
                                 "package's)")

    t = sub.add_parser("train", help="fit a network and save a model zip")
    common(t, model_in=False)
    t.add_argument("--conf", required=True,
                   help="MultiLayerConfiguration JSON or .properties file")
    t.add_argument("--output", required=True, help="model zip path")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--verbose", action="store_true")
    t.add_argument("--mesh", default=None,
                   help="device mesh, e.g. 'dp=8' or 'dp=2,tp=2': one rank "
                        "per device under torchrun (a pp axis is not "
                        "ported and exits)")
    t.add_argument("--pp-interleave", type=int, default=None,
                   help="pipeline virtual-stage interleave depth (not "
                        "ported: any value exits)")
    t.set_defaults(fn=_cmd_train)

    e = sub.add_parser("test", help="evaluate a saved model")
    common(e, model_in=True)
    e.set_defaults(fn=_cmd_test)

    r = sub.add_parser("predict", help="write predictions for an input")
    common(r, model_in=True)
    r.add_argument("--output", default="-",
                   help="CSV path or '-' for stdout")
    r.add_argument("--raw", action="store_true",
                   help="write class probabilities instead of argmax")
    r.add_argument("--has-labels", action="store_true",
                   help="input CSV has a trailing label column to strip")
    r.set_defaults(fn=_cmd_predict)

    s = sub.add_parser(
        "serve",
        help="serve an LM model zip over the streaming HTTP gateway")
    s.add_argument("--model", required=True,
                   help="LM-shaped model zip (either package's "
                        "write_model)")
    s.add_argument("--device", default="cuda",
                   help="torch device the net and the engine run on "
                        "(default cuda; cpu for a card-less host)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8421)
    s.add_argument("--slots", type=int, default=8,
                   help="concurrent KV-cache slots (batch width)")
    s.add_argument("--decode-chunk", type=int, default=8)
    s.add_argument("--prefix-cache-rows", type=int, default=0,
                   help="radix prefix cache rows (0 = off)")
    s.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunked-admission width (0 = blocking)")
    s.add_argument("--admission-policy", default="ttft",
                   choices=("ttft", "decode"))
    s.add_argument("--max-queue", type=int, default=None,
                   help="bounded admission queue (full => HTTP 429)")
    s.add_argument("--paranoid", action="store_true",
                   help="per-round health check + quarantine")
    s.add_argument("--spec-draft-len", type=int, default=0,
                   help="speculative n-gram draft length K (0 = off)")
    s.add_argument("--paged-kv", action="store_true",
                   help="paged KV memory: one block pool shared by "
                        "slots and the prefix trie (zero-copy prefix "
                        "hits, more concurrent slots per byte)")
    s.add_argument("--block-tokens", type=int, default=16,
                   help="tokens per KV block (pow2; paged mode)")
    s.add_argument("--kv-blocks", type=int, default=None,
                   help="block-pool size (default: the dense "
                        "layout's byte budget)")
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel shards (not ported: only 1)")
    s.add_argument("--use-flash-paged", default="auto",
                   choices=tuple(FLASH_PAGED_MODES),
                   help="paged-attention decode kernel (K2): auto = "
                        "the kernel on the card, the plain gather "
                        "program elsewhere; on = force the kernel; off "
                        "= the gather program always")
    s.add_argument("--role", default="any",
                   choices=("any", "prefill", "decode"),
                   help="disaggregation role a router reads from "
                        "healthz: prefill, decode or any")
    s.add_argument("--async-rounds", action="store_true",
                   help="double-buffer decode rounds: round N's token "
                        "fetch defers to the next step so the "
                        "inter-round host gap overlaps device compute "
                        "(ids stay bit-identical)")
    s.add_argument("--fused-rounds", type=int, default=0,
                   metavar="K",
                   help="fuse up to K decision-free decode rounds into "
                        "one captured graph (0 = off); SSE deltas then "
                        "arrive in chunks of up to K * decode_chunk "
                        "tokens")
    s.add_argument("--kv-host-tier-bytes", type=int, default=0,
                   help="host-DRAM spill-tier budget in bytes: trie "
                        "victims evicted under pool pressure pack into "
                        "a host LRU this large and reload through the "
                        "KV import instead of recomputing (0 = off; "
                        "needs --paged-kv and --prefix-cache-rows > 0)")
    s.add_argument("--kv-disk-tier-path", default=None,
                   help="disk-ring directory for spill-tier overflow: "
                        "payloads past the host budget demote to files "
                        "here instead of dropping (unset = host-only "
                        "tier)")
    s.add_argument("--kv-disk-tier-bytes", type=int, default=None,
                   help="byte cap for the disk ring (oldest files "
                        "dropped past it; unset = unbounded)")
    s.add_argument("--snapshot", default=None,
                   help="drain-snapshot path: written on shutdown, "
                        "restored on boot when present")
    s.add_argument("--drain-timeout", type=float, default=30.0,
                   help="seconds to settle in-flight work on shutdown")
    s.add_argument("--replica-id", default=None,
                   help="stable replica identity for a router tier "
                        "(defaults to host:port)")
    s.add_argument("--tenant", action="append", default=None,
                   metavar="SPEC",
                   help="tenant service class, repeatable: "
                        "name[:key=value]... with keys "
                        "priority/weight/slots/queue/rps/burst, e.g. "
                        "premium:priority=2:weight=4:slots=4; any "
                        "--tenant enables the weighted-fair scheduler "
                        "(none = the FIFO engine)")
    s.set_defaults(fn=_cmd_serve)

    fl = sub.add_parser(
        "fleet",
        help="run an ELASTIC fleet: N serve replicas + router + "
             "SLO-driven autoscaling controller")
    fl.add_argument("--model", required=True,
                    help="LM-shaped model zip every replica serves")
    fl.add_argument("--device", default="cuda",
                    help="torch device every replica runs on "
                         "(default cuda; cpu for a card-less host)")
    fl.add_argument("--host", default="127.0.0.1")
    fl.add_argument("--port", type=int, default=8420,
                    help="the router's port (replicas take "
                         "ephemeral ports)")
    fl.add_argument("--replicas", type=int, default=2,
                    help="initial fleet size")
    fl.add_argument("--min-replicas", type=int, default=1)
    fl.add_argument("--max-replicas", type=int, default=4)
    fl.add_argument("--ttft-slo", type=float, default=None,
                    help="TTFT p99 SLO in seconds (windowed over "
                         "the federated scrape); unset = "
                         "pressure-only control")
    fl.add_argument("--pressure-high", type=float, default=2.0,
                    help="in-flight-per-slot above this = breach")
    fl.add_argument("--pressure-low", type=float, default=0.25,
                    help="in-flight-per-slot below this = idle "
                         "(the hysteresis band between the two "
                         "holds)")
    fl.add_argument("--eval-interval", type=float, default=0.5,
                    help="control-loop period in seconds")
    fl.add_argument("--cooldown", type=float, default=5.0,
                    help="seconds after any scale event before the "
                         "next may fire")
    fl.add_argument("--affinity-block-tokens", type=int, default=16)
    fl.add_argument("--slots", type=int, default=8)
    fl.add_argument("--decode-chunk", type=int, default=8)
    fl.add_argument("--prefix-cache-rows", type=int, default=8)
    fl.add_argument("--prefill-chunk", type=int, default=0)
    fl.add_argument("--admission-policy", default="ttft",
                    choices=("ttft", "decode"))
    fl.add_argument("--paged-kv", action="store_true")
    fl.add_argument("--block-tokens", type=int, default=16)
    fl.add_argument("--kv-blocks", type=int, default=None)
    fl.add_argument("--kv-host-tier-bytes", type=int, default=0,
                    help="host-DRAM spill-tier budget per replica "
                         "(0 = off)")
    fl.add_argument("--kv-disk-tier-path", default=None,
                    help="disk-ring base directory for spill-tier "
                         "overflow (each replica rings a "
                         "subdirectory)")
    fl.add_argument("--kv-disk-tier-bytes", type=int, default=None,
                    help="per-replica disk-ring byte cap")
    fl.add_argument("--async-rounds", action="store_true",
                    help="double-buffered decode rounds on every "
                         "replica")
    fl.add_argument("--fused-rounds", type=int, default=0,
                    metavar="K",
                    help="fused multi-round decode graphs on every "
                         "replica (0 = off)")
    fl.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shards per replica (not "
                         "ported: only 1)")
    fl.add_argument("--use-flash-paged", default="auto",
                    choices=tuple(FLASH_PAGED_MODES),
                    help="every replica's paged-attention kernel "
                         "toggle (serve's --use-flash-paged)")
    fl.add_argument("--tenant", action="append", default=None,
                    metavar="SPEC",
                    help="tenant service class, repeatable: "
                         "name[:key=value]... — armed on EVERY "
                         "replica's scheduler AND the router's rate "
                         "limiter (rps/burst keys)")
    fl.set_defaults(fn=_cmd_fleet)

    rt = sub.add_parser(
        "route",
        help="front N serve replicas with the failure-tolerant "
             "prefix-aware router")
    rt.add_argument("--replicas", required=True,
                    help="comma-separated replica addresses "
                         "(host:port of running `serve` gateways of "
                         "either package — all must serve the SAME "
                         "model/seed)")
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument("--port", type=int, default=8420)
    rt.add_argument("--affinity-block-tokens", type=int, default=16,
                    help="prefix-affinity hash granularity (match "
                         "the replicas' --block-tokens under paged "
                         "KV)")
    rt.add_argument("--health-interval", type=float, default=0.25,
                    help="seconds between /v1/healthz scrapes")
    rt.add_argument("--failure-threshold", type=int, default=3,
                    help="consecutive failures before a replica's "
                         "circuit breaker opens")
    rt.add_argument("--probe-interval", type=float, default=1.0,
                    help="half-open probe period for dead replicas")
    rt.add_argument("--max-replays", type=int, default=3,
                    help="replay budget per request across replica "
                         "deaths")
    rt.add_argument("--tenant", action="append", default=None,
                    metavar="SPEC",
                    help="tenant service class, repeatable: arms the "
                         "router's per-tenant token-bucket rate "
                         "limits (rps/burst keys)")
    rt.add_argument("--journal-path", default=None,
                    help="crash-safe write-ahead journal: a router "
                         "restarted against the same file replays "
                         "open streams on live replicas, restores "
                         "tenant buckets + warm-KV beliefs, and "
                         "serves client resumes (Last-Event-ID) from "
                         "the recovered breadcrumbs")
    rt.add_argument("--fsync", default="batched",
                    choices=("per_record", "batched", "off"),
                    help="WAL durability policy: per_record "
                         "(power-loss safe, per-record latency), "
                         "batched (default: SIGKILL-safe, fsync "
                         "coalesced), off (flush-only)")
    rt.set_defaults(fn=_cmd_route)

    cl = sub.add_parser(
        "client",
        help="send one generation to a running serve/route/fleet "
             "deployment (--tenant/--priority ride the request)")
    cl.add_argument("--address", required=True,
                    help="gateway or router address host:port")
    cl.add_argument("--prompt", required=True,
                    help="comma-separated token ids, e.g. '1,4,7,2'")
    cl.add_argument("--max-new-tokens", type=int, default=16)
    cl.add_argument("--tenant", default=None,
                    help="tenant to bill the request against "
                         "(quotas, rate limits, priority class; "
                         "default = the unlabeled 'default' class)")
    cl.add_argument("--priority", type=int, default=None,
                    help="per-request priority override, clamped to "
                         "the tenant's class (you can lower your own "
                         "batch traffic, never self-boost)")
    cl.add_argument("--temperature", type=float, default=0.0)
    cl.add_argument("--stream", action="store_true",
                    help="SSE streaming instead of one blocking call")
    cl.add_argument("--timeout", type=float, default=120.0)
    cl.set_defaults(fn=_cmd_client)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
