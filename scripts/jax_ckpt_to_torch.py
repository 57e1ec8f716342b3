#!/usr/bin/env python3
"""Convert a JAX checkpoint of stereoformer_tpu into a checkpoint of the
PyTorch port (stereoformer_tpu_torch).

    JAX_PLATFORMS=cpu python scripts/jax_ckpt_to_torch.py --net LowCNN_gru \
        --ckpt saved/model_best --out model_best.pt \
        [--maxdisp 192] [--crop_h 320 --crop_w 640]

It runs where JAX is: an orbax checkpoint needs JAX to read, and the port
does not import JAX. The JAX TrainState is built as the JAX CLIs build
theirs (the registry model, initialised at one crop-sized pair) with the
JAX trainer's AMSGrad, and restored with the JAX package's
``train/checkpoint.py::restore_checkpoint``. A checkpoint without that
optimizer state (``cli/import_torch.py``'s, or another optimizer's run) is
restored with ``restore_params``, and the port's file then holds a fresh
AMSGrad state, as the JAX restore leaves one. The parameters and BatchNorm
statistics go through ``weights.state_dict_from_jax`` and the AMSGrad state
through ``weights.amsgrad_state_from_jax``; the file has the layout of the
port's ``save_checkpoint`` (``model``, ``opt_state``, ``step``, ``meta``,
the meta being the JAX checkpoint's), so the port's
``cli.infer/evaluate/analysis --ckpt`` and ``cli.train --resume`` read it
as they read their own. Every registry name converts.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("jax_ckpt_to_torch")
    p.add_argument("--net", type=str, required=True)
    p.add_argument("--ckpt", type=str, required=True,
                   help="JAX checkpoint directory (an orbax TrainState)")
    p.add_argument("--out", type=str, required=True,
                   help="the port's checkpoint file to write")
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--crop_h", type=int, default=320)
    p.add_argument("--crop_w", type=int, default=640)
    return p


def main(argv=None) -> str:
    """Convert; returns the path written."""
    opt = build_parser().parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from stereoformer_tpu.models import get_model as jax_get_model
    from stereoformer_tpu.train import TrainState as JaxTrainState
    from stereoformer_tpu.train.checkpoint import (
        checkpoint_meta,
        restore_checkpoint,
        restore_params,
    )
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import TrainState, write_checkpoint
    from stereoformer_tpu_torch.weights import (
        amsgrad_state_from_jax,
        state_dict_from_jax,
    )

    jax_model = jax_get_model(opt.net, max_disp=opt.maxdisp)
    dummy = jnp.zeros((1, opt.crop_h, opt.crop_w, 3), jnp.float32)
    variables = jax.jit(lambda l, r: jax_model.init(
        jax.random.PRNGKey(0), l, r, iters=1, train=False))(dummy, dummy)
    # the JAX trainer's optimizer: a scheduled rate keeps a count of its own
    tx = optax.amsgrad(lambda count: 1e-3, b1=0.9, b2=0.999)
    target = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]))
    try:
        state = restore_checkpoint(opt.ckpt, target)
        with_optimizer = True
    except (KeyError, ValueError):
        state = restore_params(opt.ckpt, target)
        with_optimizer = False
    state = jax.tree_util.tree_map(np.asarray, state)

    model = get_model(opt.net, device="cpu", max_disp=opt.maxdisp)
    model.load_state_dict(state_dict_from_jax(
        opt.net, {"params": state.params, "batch_stats": state.batch_stats}))
    write_checkpoint(opt.out, TrainState(
        step=int(state.step), model=model,
        opt_state=amsgrad_state_from_jax(state.opt_state, model)),
        checkpoint_meta(opt.ckpt))
    print(f"wrote {opt.out}: {opt.net}, step {int(state.step)}, "
          f"{'with its' if with_optimizer else 'a fresh'} AMSGrad state")
    return opt.out


if __name__ == "__main__":
    main()
