"""The part CLIs' checkpoint, resume, schedule and eval flags on the CPU.

Printed lines are held against the JAX part CLIs' for the same flags
(part1: one device on both sides), with the checkpoint directory's path
replaced.  Multi-rank legs (``--unsync-bn``, ``--dist-eval``) spawn 2 gloo
ranks; their checks are the reference's identities: each rank gets its own
BN row back, and the sharded eval prints what the one-rank eval prints.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import common as tcommon
from distributed_machine_learning_tpu_torch.cli import part1 as tpart1
from distributed_machine_learning_tpu_torch.cli import part2b as tpart2b
from distributed_machine_learning_tpu_torch.cli import part3 as tpart3
from distributed_machine_learning_tpu_torch.train import checkpoint as tckpt

SMALL = ["--model", "vggtest", "--batch-size", "8", "--max-iters", "2", "--eval-batches", "1",
         "--eval-batch-size", "16"]
KEYS = ("Saved checkpoint", "Saving checkpoint", "Resumed from", "No checkpoint",
        "WARNING: checkpoint", "WARNING: --fused-update", "WARNING: --dist-eval",
        "WARNING: --unsync-bn", "NOTE:", "native loader")


def _lines(out: str, root: str) -> list:
    out = out.replace(root, "<D>")
    return [ln for ln in out.splitlines() if ln.startswith(KEYS)]


def _jax_part1(argv):
    from distributed_machine_learning_tpu.cli import part1 as jpart1

    jpart1.main(argv)


@pytest.mark.parametrize("second", [["--optimizer", "adamw"], ["--fused-update"]])
def test_part1_save_resume_lines_match_jax(tmp_path, capsys, second):
    """Save, then resume under another optimizer (the momentum reset's
    WARNING) or with --fused-update under sgd (the reference update's
    WARNING): the same lines as the JAX CLI's, and the same checkpoints."""
    outs = {}
    for name, run in (("port", lambda a: tpart1.main([*a, "--device", "cpu"])),
                      ("jax", _jax_part1)):
        d = str(tmp_path / name)
        run([*SMALL, "--ckpt-dir", d, "--keep-last-n", "1"])
        run([*SMALL, "--ckpt-dir", d, "--keep-last-n", "1", "--resume", *second])
        outs[name] = _lines(capsys.readouterr().out, d)
        assert sorted(os.listdir(d)) == ["step_4"]  # --keep-last-n 1 after two saves
    assert outs["port"] == outs["jax"], outs
    assert "Resumed from <D>/step_2 (step 2)" in outs["port"]


def test_resume_restores_bit_for_bit_and_continues_the_schedule(tmp_path):
    d = str(tmp_path)
    flags = [*SMALL, "--device", "cpu", "--ckpt-dir", d, "--optimizer", "lars",
             "--lr-schedule", "cosine", "--warmup-steps", "1", "--grad-accum", "2"]
    first = tpart1.main(flags)
    saved = tckpt.restore_checkpoint(tckpt.latest_checkpoint(d))
    for k, p in first["state"].params.items():
        assert torch.equal(p, saved.params[k])
    assert saved.step == 2 and type(saved.config).__name__ == "LARSConfig"
    again = tpart1.main([*flags, "--resume"])
    assert again["state"].step == 4
    assert tckpt.checkpoint_config(tckpt.latest_checkpoint(d)) == again["state"].config


def test_async_save_and_resume_auto_after_an_injected_failure(tmp_path, monkeypatch,
                                                              capsys):
    from distributed_machine_learning_tpu_torch.train import loop

    real, calls = loop.train_epoch, [0]

    def flaky(*a, **k):  # the second epoch's training raises once
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected")
        return real(*a, **k)

    monkeypatch.setattr(loop, "train_epoch", flaky)
    d = str(tmp_path / "auto")
    res = tpart1.main([*SMALL, "--device", "cpu", "--ckpt-dir", d, "--resume", "auto",
                       "--epochs", "2", "--async-ckpt"])
    out = _lines(capsys.readouterr().out, d)
    assert res["events"].restarts == 1 and res["state"].step == 4
    assert out == ["No checkpoint under <D>; starting from scratch.",
                   "Saving checkpoint to <D>/step_2 (async)",
                   "Resumed from <D>/step_2 (step 2)",
                   "Saving checkpoint to <D>/step_4 (async)"]
    assert tckpt.validate_checkpoint(os.path.join(d, "step_4")) == []


def test_resume_auto_gives_up_after_max_restarts(tmp_path, monkeypatch, capsys):
    from distributed_machine_learning_tpu_torch.train import loop

    def always(*a, **k):
        raise RuntimeError("down")

    monkeypatch.setattr(loop, "train_epoch", always)
    with pytest.raises(RuntimeError, match="down"):
        tpart1.main([*SMALL, "--device", "cpu", "--ckpt-dir", str(tmp_path), "--resume",
                     "auto", "--max-restarts", "1"])
    out = capsys.readouterr().out
    assert "[supervisor] giving up after 1 restart(s): RuntimeError: down" in out
    assert "restarts" in out  # the resilience summary, printed on a crashed run too


def test_native_loader_flags(capsys, monkeypatch):
    from distributed_machine_learning_tpu_torch.data import native_loader

    res = tpart1.main([*SMALL, "--device", "cpu", "--loader", "native"])
    assert len(res["losses"]) == 2
    monkeypatch.setattr(native_loader, "native_available", lambda: False)
    monkeypatch.setattr(native_loader, "native_unavailable_reason", lambda: "no g++")
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        tpart1.main([*SMALL, "--device", "cpu", "--loader", "native"])
    capsys.readouterr()
    tpart1.main([*SMALL, "--device", "cpu", "--loader", "auto"])
    assert "native loader unavailable, using python loader (no g++)" in capsys.readouterr().out


def _rank(rank, world, init_method, part, argv):
    import io
    from contextlib import redirect_stdout

    mod = {"part2b": tpart2b, "part3": tpart3}[part]
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = mod.main([*argv, "--num-nodes", str(world), "--rank", str(rank)],
                       init_method=init_method)
    # Across the result queue: numpy, never tensors (shared memory dies with the rank).
    stats = {k: v.numpy().copy() for k, v in res["state"].batch_stats.items()}
    return buf.getvalue(), stats


def test_unsync_bn_saves_stacked_rows_and_each_rank_gets_its_own_back(tmp_path):
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    d = str(tmp_path / "q")
    flags = [*SMALL, "--device", "cpu", "--ckpt-dir", d, "--unsync-bn"]
    first = spawn(_rank, 2, ("part3", flags), timeout_s=300)
    assert not all(np.array_equal(first[0][1][k], first[1][1][k]) for k in first[0][1])
    index = json.loads(open(os.path.join(d, "step_2", "state", "index.json")).read())
    stats = {k: v for k, v in (index.get("leaves", index)).items() if k.startswith("batch_")}
    assert stats and all(v["shape"][0] == 2 for v in stats.values())
    # Resumed with --max-iters 0: the restored rows, untouched by a step.
    second = spawn(_rank, 2, ("part3", [*flags, "--resume", "--max-iters", "0"]),
                   timeout_s=300)
    for r in range(2):
        assert all(np.array_equal(second[r][1][k], first[r][1][k]) for k in first[r][1])
    # A plain checkpoint restored into quirk mode: every rank the same stats.
    p = str(tmp_path / "plain")
    spawn(_rank, 2, ("part3", [*SMALL, "--device", "cpu", "--ckpt-dir", p]), timeout_s=300)
    third = spawn(_rank, 2, ("part3", [*SMALL, "--device", "cpu", "--ckpt-dir", p,
                                       "--unsync-bn", "--resume", "--max-iters", "0"]),
                  timeout_s=300)
    assert all(np.array_equal(third[0][1][k], third[1][1][k]) for k in third[0][1])
    # ... and a per-rank checkpoint without --unsync-bn is refused by name.
    with pytest.raises(RuntimeError, match="per-rank BN statistics"):
        spawn(_rank, 2, ("part3", [*SMALL, "--device", "cpu", "--ckpt-dir", d, "--resume"]),
              timeout_s=300)


def test_dist_eval_prints_what_the_one_rank_eval_prints(tmp_path):
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    flags = [*SMALL, "--device", "cpu", "--eval-batches", "3", "--eval-batch-size", "20"]

    def test_line(out):
        return re.search(r"Test set: .*", out).group(0)

    plain = spawn(_rank, 2, ("part2b", flags), timeout_s=300)
    sharded = spawn(_rank, 2, ("part2b", [*flags, "--dist-eval"]), timeout_s=300)
    assert test_line(sharded[0][0]) == test_line(plain[0][0])
    assert "Test set:" not in sharded[1][0]  # rank 0 prints


def test_part1_dist_eval_and_unsync_bn_warn_as_jax_warns(capsys):
    from distributed_machine_learning_tpu.cli import part1 as jpart1

    outs = []
    for run in (lambda a: tpart1.main([*a, "--device", "cpu"]), jpart1.main):
        run([*SMALL, "--max-iters", "1", "--dist-eval", "--unsync-bn"])
        outs.append(_lines(capsys.readouterr().out, "\0"))
    assert outs[0] == outs[1] and len(outs[0]) == 2, outs


def test_fused_update_warns_in_the_parts_and_errors_in_lm_as_jax(capsys):
    from distributed_machine_learning_tpu.cli import lm as jlm

    from distributed_machine_learning_tpu_torch.cli import lm as tlm

    args = tcommon.parse_flags(tcommon.make_flag_parser("x"),
                               ["--fused-update", "--optimizer", "lars"])
    assert args.fused_update  # the parser takes it; run_part warns (test above)
    for opt in ("sgd", "lars"):
        errors = []
        for main, extra in ((tlm.main, ["--device", "cpu"]), (jlm.main, [])):
            with pytest.raises(ValueError) as exc:
                main(["--optimizer", opt, "--fused-update", "--max-iters", "1", *extra])
            errors.append(str(exc.value))
        assert errors[0] == errors[1] and "adamw only" in errors[0]
    with pytest.raises(ValueError) as port:
        tlm.main(["--optimizer", "lars", "--momentum-dtype", "bfloat16", "--device", "cpu"])
    with pytest.raises(ValueError) as ref:
        jlm.main(["--optimizer", "lars", "--momentum-dtype", "bfloat16"])
    assert str(port.value) == str(ref.value)
