"""The command line: ``python -m deeplearning4j_tpu_torch.cli serve``.

The ``serve`` subcommand of ``deeplearning4j_tpu/cli/driver.py``: load an
LM-shaped model zip (either package's ``write_model``) onto the card
(``--device``, default ``cuda``) and run the streaming HTTP gateway over
it (serving/gateway.py): blocking and SSE generation, cancel, metrics,
drain to a snapshot on shutdown, restore on boot when the snapshot
exists. The parser is JAX's: ``--tenant`` (repeatable,
``TenantSpec.parse``'s spelling) turns on the weighted-fair scheduler,
``--kv-host-tier-bytes``, ``--kv-disk-tier-path`` and
``--kv-disk-tier-bytes`` the KV spill tiers; ``--tp``, the flag of the
one knob the port does not carry yet, is parsed, and any value but 1
exits with a message naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import argparse
import sys

#: --use-flash-paged CLI spelling -> DecodeEngine toggle value (JAX's
#: "interpret", the Pallas interpreter, has no counterpart here)
FLASH_PAGED_MODES = {"auto": None, "on": True, "off": False}

#: flags of knobs the port refuses: (attribute, default, ROADMAP item)
UNPORTED_FLAGS = (
    ("tp", 1, "8 (tensor parallelism)"),
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


def _cmd_serve(args) -> int:
    import time as _time

    gw = gateway_from_args(args).start()
    # flush: a parent process reads this line through a pipe as the
    # boot handshake
    print(f"serving on {gw.address} "
          f"(POST /v1/generate, GET /v1/healthz, GET /v1/metrics)",
          flush=True)
    try:
        while True:
            _time.sleep(0.5)
    except KeyboardInterrupt:
        print("draining...")
    finally:
        summary = gw.drain(timeout_s=args.drain_timeout)
        gw.close()
        if summary["snapshot"]:
            print(f"snapshot ({summary['carried']} in-flight "
                  f"requests) -> {summary['snapshot']}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.cli",
        description="Serve deeplearning4j_tpu_torch models "
                    "(the serve subcommand of the JAX package's CLI).")
    sub = p.add_subparsers(dest="command", required=True)

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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
