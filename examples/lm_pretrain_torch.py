"""End-to-end LM training driver on the PyTorch port (``repro_torch``):
train a decoder for a few hundred steps on synthetic bigram data and
watch the loss approach the chain's entropy. It exercises the port's
whole training path: per-layer recomputation (``remat``), attention in
query chunks, the fused LoRA op's forward and backward kernels, AdamW
with a cosine schedule over every tensor, and the checkpoint store.

  PYTHONPATH=src python examples/lm_pretrain_torch.py --arch gemma-2b --steps 200
  PYTHONPATH=src python examples/lm_pretrain_torch.py --device cpu --steps 20

It runs on the CUDA card unless ``--device cpu`` is given, and takes the
reduced variant of ``--arch`` (a dense, mixture-of-experts, state-space
or hybrid decoder, or Whisper's encoder-decoder: ``gemma-2b``,
``minitron-4b``, ``olmoe-1b-7b``, ``llama4-maverick-400b-a17b``,
``mamba2-2.7b``, ``hymba-1.5b``, ``whisper-small``), as
``examples/lm_pretrain.py`` does; at full width, call ``train`` with
``get_config(arch)``'s weights. A MoE decoder's loss carries its
load-balance term; Mamba2 has no attention, so ``q_chunk`` does not reach
it; Hymba's sequence length must be a multiple of its SSD chunk,
``min(128, seq)``; Whisper's every batch carries zero ``frames`` (batch,
encoder_seq, d_model), as the reference example's does.
``main(argv)`` takes the arguments as a list and returns the losses.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data import make_bigram_lm
from repro_torch.device import resolve_device
from repro_torch.fed import simulation
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw, apply_updates, cosine_decay
from repro_torch.optim.optimizers import tree_leaves, tree_map

WARMUP_STEPS = 20


def train(cfg: ModelConfig, params: Transformer, data: Dict[str, np.ndarray],
          *, steps: int, batch: int, lr: float, remat: bool, q_chunk: int,
          device, rng_seed: int = 0,
          on_step: Optional[Callable[[int, torch.Tensor], None]] = None
          ) -> Tuple[Transformer, List[float]]:
    """``steps`` AdamW steps (``cosine_decay(lr, steps, warmup_steps=20)``)
    of the next-token loss over every tensor of ``params`` (the LoRA masks
    included), each on ``batch`` rows of ``data`` picked by
    ``np.random.default_rng(rng_seed)`` (with zero ``frames`` for an
    encoder-decoder), on ``device`` (None = CUDA, which
    must exist). ``on_step(i, loss)`` is called after each step with the
    loss as a device tensor. Returns the trained weights and the losses.

    The update is the reference's, leaf by leaf: every leaf keeps its own
    AdamW state, whose step count is the shared one, so the numbers are
    those of one update over the whole tree, while a leaf's old weights,
    gradient and moments are let go as soon as its update is made (at
    Gemma-2B's 2.5 B parameters, one update over the tree would hold about
    70 GB at once). Drop the caller's reference to ``params`` to let the
    initial weights go after the first step."""
    dev = resolve_device(device)
    opt = adamw(cosine_decay(lr, steps, warmup_steps=WARMUP_STEPS))
    tree = tree_map(lambda t: t.detach().to(dev), params.tree())
    del params
    skeleton = tree_map(lambda _: None, tree)
    states = [opt.init(p) for p in tree_leaves(tree)]
    rng = np.random.default_rng(rng_seed)
    losses = []
    for i in range(steps):
        picks = rng.integers(0, len(data["tokens"]), size=batch)
        b = {k: torch.from_numpy(data[k][picks]).to(dev)
             for k in ("tokens", "labels")}
        if cfg.arch_type == "audio":
            b["frames"] = torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                      device=dev)
        loss, grads = simulation.pretrain_loss_and_grads(
            tree, b, cfg, remat=remat, q_chunk=q_chunk)
        g = tree_leaves(grads)
        leaves = tree_leaves(tree)
        del grads, tree
        # the update as one named range, so that a profile shows it apart
        with torch.no_grad(), torch.profiler.record_function("adamw"):
            for j in range(len(leaves)):
                upd, states[j] = opt.update(g[j], states[j], leaves[j])
                g[j] = None
                leaves[j] = apply_updates(leaves[j], upd)
        it = iter(leaves)
        tree = tree_map(lambda _: next(it), skeleton)
        losses.append(loss)
        if on_step is not None:
            on_step(i, loss)
    return Transformer.from_tree(cfg, tree), [float(l) for l in losses]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    args = parse_args(argv)
    cfg = get_reduced(args.arch)
    if cfg.arch_type in ("encoder",):
        raise SystemExit("pick a decoder arch")
    dev = resolve_device(args.device)
    data = make_bigram_lm(4096, args.seq, cfg.vocab_size, seed=0)
    # standalone CLI progress on the wall clock, as the reference prints it
    t0 = time.time()          # repro: allow=clock-discipline (CLI progress)

    def report(i, loss):
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}: loss={float(loss):.4f} "
                  # repro: allow=clock-discipline (CLI progress)
                  f"({(time.time() - t0):.1f}s)", flush=True)

    params, losses = train(
        cfg, model_lib.init_params(cfg, seed=0, device=dev), data,
        steps=args.steps, batch=args.batch, lr=args.lr, remat=True,
        q_chunk=64, device=dev, on_step=report)
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps, params.tree(),
                        meta={"arch": cfg.name, "loss": losses[-1]})
        print("checkpoint saved:", args.ckpt_dir)
    return losses


if __name__ == "__main__":
    main()
