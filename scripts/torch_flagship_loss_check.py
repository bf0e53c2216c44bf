"""Do the JAX package's losses rise where the port's do? Phase A's
question, asked on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_flagship_loss_check.py [--t 512]

``chip_smoke.py``'s training phase A trains the width-1024 flagship
(``transformer_lm_flagship(vocab=64, width=1024, n_layers=8, n_heads=8,
lr=1e-3, warmup_steps=2, total_steps=100, seed=11)``) for 4 ``fit``
steps at B=2, T=2048 on the Markov task, and its losses rise over those
steps on the card, on K1 and on dense attention alike. This script
writes that net's init with the port as a model zip, loads the zip into
both packages on the CPU (dense attention on both sides), runs the same
4 ``fit`` steps on the same batches in each, and prints both loss
trajectories, their largest relative difference, and whether each
rises. ``--t`` sets T (default 512, a quarter of phase A's: the
attention scores of T=2048 take several GB per package on the host).
Imports both packages: a comparison script, not part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONF = dict(vocab=64, width=1024, n_layers=8, n_heads=8, lr=1e-3,
            warmup_steps=2, total_steps=100, seed=11)
BATCH, STEPS = 2, 4


def _batches(t):
    from deeplearning4j_tpu_torch.datasets.markov import markov_lm_batches

    f, y, floor = markov_lm_batches(CONF["vocab"], BATCH * STEPS, t,
                                    seed=0, sample_seed=1)
    return [(f[i:i + BATCH], y[i:i + BATCH])
            for i in range(0, len(f), BATCH)], floor


def _losses(net, batches):
    out, walls = [], []
    for f, y in batches:
        t0 = time.perf_counter()
        net.fit(f, y)
        out.append(float(net.score_value))
        walls.append(time.perf_counter() - t0)
    return out, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=512)
    t = ap.parse_args(argv).t
    import jax

    jax.config.update("jax_platforms", "cpu")
    from deeplearning4j_tpu.nn.multilayer import (
        MultiLayerNetwork as JaxNet,
    )
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model,
        write_model,
    )

    batches, floor = _batches(t)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "flagship.zip")
        conf = transformer_lm_flagship(**CONF)
        for c in conf.confs:
            if hasattr(c.layer, "use_flash"):
                c.layer.use_flash = False
        write_model(MultiLayerNetwork(conf, device="cpu").init(), path)
        jnet = JaxNet.load(path)           # the zip's conf: use_flash off
        jax_losses, jax_walls = _losses(jnet, batches)
        del jnet
        port_losses, port_walls = _losses(
            restore_model(path, device="cpu"), batches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(port_losses, jax_losses))
    out = {"t": t, "batch": BATCH, "steps": STEPS, "conf": CONF,
           "entropy_floor": floor, "jax_losses": jax_losses,
           "port_losses": port_losses, "max_rel_diff": rel,
           "jax_rises": jax_losses[-1] > jax_losses[0],
           "port_rises": port_losses[-1] > port_losses[0],
           "jax_s_per_step": jax_walls, "port_s_per_step": port_walls,
           "device": "cpu"}
    print(f"T={t}, B={BATCH}: JAX losses "
          f"{[round(x, 6) for x in jax_losses]}, port "
          f"{[round(x, 6) for x in port_losses]} (entropy floor "
          f"{floor:.4f}); max rel diff {rel:.3e}; rises: JAX "
          f"{out['jax_rises']}, port {out['port_rises']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
