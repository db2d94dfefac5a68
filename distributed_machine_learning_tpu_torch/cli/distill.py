"""Draft-from-target distillation: one command from a target checkpoint to
a speculative-decoding draft.

Counterpart of ``distributed_machine_learning_tpu/cli/distill.py``::

    python -m distributed_machine_learning_tpu_torch.cli.distill \\
        --target-ckpt-dir runs/lm --d-model 2048 --n-layers 8 --n-heads 16 \\
        --n-kv-heads 4 --vocab 32000 --draft-d-model 512 --draft-n-layers 2 \\
        --draft-n-heads 16 --draft-n-kv-heads 4 --ckpt-dir runs/draft

then serve both::

    python -m distributed_machine_learning_tpu_torch.cli.generate \\
        --ckpt-dir runs/lm --draft-ckpt-dir runs/draft --spec-gamma 4 ...

The objective is Hinton's logit distillation: the soft cross-entropy
against the teacher's temperature-softened distribution, scaled by T² so
the gradients keep their size as T grows, plus ``--ce-weight`` × the hard
next-token CE on the same stream.  The teacher (the target, in the compute
dtype) runs frozen in the same step; the student trains on the port's
AdamW at ``AdamWConfig()``'s defaults (the unfused update, as the
reference).  Data comes from ``--data-dir`` (the byte corpus) or
``cli.lm``'s synthetic stream; the loop prints the loss every 20
iterations and times every iteration but the first, as ``cli.lm`` does.
Runs on the GPU unless ``--device cpu`` is given.

A draft's prefill runs K1 at L ≥ 1024 on the card, which takes head dims
32, 64 and 128 only: pick ``--draft-d-model``/``--draft-n-heads`` to match
(d512 / 16 heads, or the default d1024 / 8 heads of a d2048 target).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from distributed_machine_learning_tpu_torch import resolve_device
from distributed_machine_learning_tpu_torch.cli.common import SEED
from distributed_machine_learning_tpu_torch.cli.generate import restore_lm_params
from distributed_machine_learning_tpu_torch.cli.lm import synthetic_tokens
from distributed_machine_learning_tpu_torch.data.text import (
    VOCAB_SIZE,
    TextWindowLoader,
    load_corpus,
)
from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
from distributed_machine_learning_tpu_torch.train.checkpoint import save_checkpoint
from distributed_machine_learning_tpu_torch.train.lm_step import (
    _apply_update,
    _backward,
    init_lm_state,
)
from distributed_machine_learning_tpu_torch.train.losses import lm_cross_entropy


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target-ckpt-dir", dest="target_ckpt_dir", required=True,
                   help="cli.lm checkpoint of the target (teacher) model")
    # The target's architecture: it must match the checkpoint.
    p.add_argument("--d-model", dest="d_model", default=256, type=int)
    p.add_argument("--n-layers", dest="n_layers", default=4, type=int)
    p.add_argument("--n-heads", dest="n_heads", default=8, type=int)
    p.add_argument("--n-kv-heads", dest="n_kv_heads", default=None, type=int)
    p.add_argument("--vocab", default=None, type=int,
                   help="default: byte-level 257")
    p.add_argument("--draft-d-model", dest="draft_d_model", default=None, type=int,
                   help="default: d_model // 2")
    p.add_argument("--draft-n-layers", dest="draft_n_layers", default=2, type=int)
    p.add_argument("--draft-n-heads", dest="draft_n_heads", default=None, type=int,
                   help="default: n_heads // 2 (min 1)")
    p.add_argument("--draft-n-kv-heads", dest="draft_n_kv_heads", default=None,
                   type=int)
    p.add_argument("--kd-temperature", dest="kd_temperature", default=2.0, type=float,
                   help="soften teacher and student logits by this factor for the "
                        "KD term; the KD loss scales by T^2")
    p.add_argument("--kd-weight", dest="kd_weight", default=1.0, type=float)
    p.add_argument("--ce-weight", dest="ce_weight", default=0.5, type=float,
                   help="weight of the hard next-token CE (0 = pure distillation)")
    p.add_argument("--data-dir", dest="data_dir", default=None,
                   help="byte-level text corpus (the target's training corpus); "
                        "default: the synthetic stream")
    p.add_argument("--seq-len", dest="seq_len", default=256, type=int)
    p.add_argument("--batch-size", dest="batch_size", default=8, type=int)
    p.add_argument("--max-iters", dest="max_iters", default=400, type=int)
    p.add_argument("--lr", default=None, type=float, help="AdamW learning-rate override")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--ckpt-dir", dest="ckpt_dir", required=True,
                   help="write the distilled draft checkpoint here "
                        "(cli.generate --draft-ckpt-dir loads it)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def make_distill_step(student_model, teacher_model, kd_weight: float,
                      ce_weight: float, kd_temperature: float):
    """``step(state, tokens, targets) -> (state, (loss, kd, ce))`` for the
    student's ``TrainState``: the frozen teacher's softened distribution,
    then the student's loss, its gradients and the state's optimizer
    update, in place."""
    if kd_temperature <= 0:
        raise ValueError(f"kd_temperature must be > 0, got {kd_temperature}")
    T = kd_temperature

    def step(state, tokens, targets):
        with torch.no_grad():
            t_probs = torch.softmax(teacher_model(tokens).float() / T, dim=-1)
        s_logits = student_model(tokens)
        # Soft cross-entropy H(teacher_T, student_T)·T²: KL(t‖s)·T² up to
        # the teacher's entropy, so the gradients are the same.
        s_logp = torch.log_softmax(s_logits.float() / T, dim=-1)
        kd = -torch.mean(torch.sum(t_probs * s_logp, dim=-1)) * T * T
        ce = lm_cross_entropy(s_logits, targets)
        grads, loss = _backward(student_model, kd_weight * kd + ce_weight * ce, None)
        _apply_update(state, grads)
        return state, (loss, kd.detach(), ce.detach())

    return step


def _batches(args, vocab: int):
    if args.data_dir is not None:
        corpus = load_corpus(args.data_dir)
        print(f"corpus: {len(corpus)} tokens from {args.data_dir}")
        yield from TextWindowLoader(corpus, args.batch_size, args.seq_len, seed=SEED)
        return
    rng = np.random.default_rng(SEED)
    while True:  # cli.lm's stream, the one the target trained on
        block = synthetic_tokens(rng, args.batch_size, args.seq_len, vocab)
        yield block[:, :-1], block[:, 1:]


def main(argv=None) -> str:
    """Distill and save; returns the draft checkpoint's path."""
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    vocab = args.vocab or VOCAB_SIZE
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    teacher = TransformerLM(vocab_size=vocab, d_model=args.d_model,
                            n_layers=args.n_layers, n_heads=args.n_heads,
                            n_kv_heads=args.n_kv_heads, compute_dtype=dtype,
                            device=device)
    teacher.load_state_dict(restore_lm_params(args.target_ckpt_dir))
    teacher = teacher.to(dtype).eval()  # its logits are targets, not gradients
    student = TransformerLM(vocab_size=vocab,
                            d_model=args.draft_d_model or args.d_model // 2,
                            n_layers=args.draft_n_layers,
                            n_heads=args.draft_n_heads or max(1, args.n_heads // 2),
                            n_kv_heads=args.draft_n_kv_heads, compute_dtype=dtype,
                            device=device)
    cfg = AdamWConfig()
    if args.lr is not None:
        cfg = dataclasses.replace(cfg, learning_rate=args.lr)
    state = init_lm_state(student, config=cfg)
    step = make_distill_step(student, teacher, args.kd_weight, args.ce_weight,
                             args.kd_temperature)
    batches = _batches(args, vocab)
    n_student = sum(p.numel() for p in student.parameters())
    print(f"distill: teacher d{args.d_model}x{args.n_layers}L -> "
          f"draft d{student.d_model}x{student.n_layers}L "
          f"({n_student / 1e6:.2f}M params), T={args.kd_temperature}, "
          f"kd={args.kd_weight}, ce={args.ce_weight}")
    total, t_prev = 0.0, None
    for it in range(args.max_iters):
        x, y = next(batches)
        state, (loss, kd, ce) = step(state, torch.from_numpy(x).long().to(device),
                                     torch.from_numpy(y).long().to(device))
        loss_v = float(loss)  # the step's sync, as the reference's loss fetch
        now = time.perf_counter()
        if t_prev is not None:
            total += now - t_prev
        t_prev = now
        if it % 20 == 0:
            print(f"iter {it}: loss {loss_v:.4f} "
                  f"(kd {float(kd):.4f}, ce {float(ce):.4f})", flush=True)
    if args.max_iters > 1:
        print(f"Total execution time: {total:.2f}s  "
              f"Average: {total / (args.max_iters - 1):.4f}s/iter")
    path = save_checkpoint(args.ckpt_dir, state)
    print(f"draft checkpoint: {path}")
    return path


if __name__ == "__main__":
    main()
