"""Training command line (counterpart of bigdl_tpu/models/train.py): the
`ptb` language model with `--model llama`, trained by the local
Optimizer on one CUDA card (or the CPU with `--device cpu`).

    python -m bigdl_tpu_torch.models.train ptb --model llama --max-iter 100
    BIGDL_TPU_FUSED_UPDATE=1 python -m bigdl_tpu_torch.models.train ptb --model llama
    python -m bigdl_tpu_torch.models.train ptb --model llama --device cpu --max-iter 3

Without a PTB folder the synthetic Zipf corpus is used, so the command
runs anywhere. Not ported yet (ROADMAP): the lenet/resnet/inception/vgg
subcommands, `--model lstm` and `--model transformer`, the pipelined,
sequence-parallel and MoE branches, and the checkpoint, summary, trace
and compile-cache options.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np


def _seed_of(args) -> int:
    """--seed wins, else the BIGDL_TPU_SEED knob."""
    if args.seed is not None:
        return int(args.seed)
    from bigdl_tpu_torch.utils import config
    return int(config.get("SEED"))


def _common(p: argparse.ArgumentParser):
    p.add_argument("-f", "--folder", default=None, help="dataset folder")
    p.add_argument("-b", "--batch-size", type=int, default=None)
    p.add_argument("-e", "--max-epoch", type=int, default=None)
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--optimizer", default=None,
                   help="sgd|adam|rmsprop (model default otherwise)")
    p.add_argument("--seed", type=int, default=None,
                   help="init RNG seed (default: BIGDL_TPU_SEED)")
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="optimizer steps per dispatch; only 1 is ported "
                        "(default BIGDL_TPU_STEPS_PER_CALL)")
    p.add_argument("--accum-steps", type=int, default=None,
                   help="gradient accumulation: microbatches per "
                        "optimizer step (batch size must divide; default "
                        "BIGDL_TPU_ACCUM_STEPS)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu")


def _end_trigger(args, default_epochs):
    from bigdl_tpu_torch.optim.trigger import Trigger
    if args.max_iter:
        return Trigger.max_iteration(args.max_iter)
    return Trigger.max_epoch(args.max_epoch or default_epochs)


def _finish(opt, args, app):
    if args.accum_steps:
        opt.set_accum_steps(args.accum_steps)
    params, state = opt.optimize()
    print(f"{app}: finished at iter {opt.state['neval']} "
          f"loss {opt.state.get('loss', float('nan')):.4f}")
    return params, state


def _method(args, default):
    from bigdl_tpu_torch.optim.method import SGD, Adam, RMSprop
    lr = args.learning_rate
    if args.optimizer == "adam":
        return Adam(lr or 1e-3)
    if args.optimizer == "rmsprop":
        return RMSprop(lr or 1e-3)
    if args.optimizer == "sgd":
        return SGD(lr or 0.01, momentum=0.9)
    # --learning-rate alone keeps the model's default method and only
    # overrides the base LR
    if lr is not None:
        default.learning_rate = lr
    return default


def train_ptb(args):
    """PTB language model: contiguous (batch, num_steps) token windows,
    a tied-head LlamaLM, CrossEntropy per time step."""
    from bigdl_tpu_torch.dataset import text as T
    from bigdl_tpu_torch.dataset.core import IteratorDataSet, MiniBatch
    from bigdl_tpu_torch.nn.criterion import (CrossEntropyCriterion,
                                              TimeDistributedCriterion)
    from bigdl_tpu_torch.optim.local import Optimizer
    from bigdl_tpu_torch.optim.method import Adam

    for flag in ("pipeline_stages", "seq_parallel", "moe_experts"):
        if getattr(args, flag) > 1:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet (ROADMAP, "
                f"the distributed slice: parallel/ and its models)")
    if args.model != "llama":
        raise NotImplementedError(
            f"--model {args.model} is not ported yet (ROADMAP slice 2 "
            f"leftovers: models/rnn.py, LSTM and the PTB transformer); "
            f"use --model llama")
    from bigdl_tpu_torch.interop.huggingface import LlamaLM

    words = T.ptb_raw(args.folder, "train")
    d = T.Dictionary([words], vocab_size=args.vocab_size - 1)
    bs = args.batch_size or 20
    xs, ys = T.ptb_batches(words, d, bs, args.num_steps)

    def epoch():
        for i in range(xs.shape[0]):
            yield MiniBatch(xs[i], ys[i])

    # modern decoder (RMSNorm + RoPE + GQA + SwiGLU), dense attention, as
    # the reference's CLI builds it
    model = LlamaLM(d.vocab_size, args.hidden, 4, args.kv_heads,
                    args.hidden * 4, args.layers, tied=True)
    crit = TimeDistributedCriterion(CrossEntropyCriterion(),
                                    size_average=True)
    opt = Optimizer(model, IteratorDataSet(epoch), crit,
                    _method(args, Adam(1e-3)), seed=_seed_of(args),
                    steps_per_call=args.steps_per_call, device=args.device)
    opt.set_end_when(_end_trigger(args, 1))
    params, state = _finish(opt, args, f"ptb-{args.model}")
    print(f"ptb perplexity ~ {np.exp(opt.state['loss']):.1f}")
    return params, state


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser(prog="bigdl_tpu_torch.models.train")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ptb", help="PTB language model")
    _common(p)
    p.add_argument("--model", choices=["lstm", "transformer", "llama"],
                   default="lstm")
    p.add_argument("--kv-heads", type=int, default=2,
                   help="grouped-query KV heads for --model llama")
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--vocab-size", type=int, default=10000)
    p.add_argument("--pipeline-stages", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--seq-parallel", type=int, default=0,
                   help="not ported yet")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="not ported yet")
    args = ap.parse_args(argv)
    return {"ptb": train_ptb}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
