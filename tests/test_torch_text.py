"""The port's byte corpus (data/text.py) and ``cli.lm --data-dir`` vs the
JAX package.

On a corpus the test writes (text files in nested directories, one of
them with an extension the loader skips), the port's ``load_corpus``,
``split_corpus`` (its normal split, its degrade path and its refusal),
``TextWindowLoader`` (with ``rank``/``world`` striding) and
``eval_windows`` return JAX's arrays element for element.  End to end,
``cli.lm --data-dir D --eval-batches 2`` (the port's ``main``, with the
reference's initial weights converted into the port) trains 3 steps and
evaluates; JAX's ``make_lm_train_step`` and ``evaluate_lm`` run the same
corpus, windows and weights as its ``main`` would.  f32 on both sides:
the losses and the eval NLL within 1e-5 relative (``tests/test_torch_lm_train.py``'s
loss tolerance).
"""

import numpy as np
import pytest

from distributed_machine_learning_tpu_torch.data import text

SEQ, BATCH, STEPS = 64, 2, 3
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(7)
    (root / "b" / "c").mkdir(parents=True)
    for i, name in enumerate(("a.txt", "b/z.py", "b/c/m.md", "b/c/skip.bin", "b/n.json")):
        words = [("w%d" % w) for w in rng.integers(0, 50, 300 + 40 * i)]
        (root / name).write_text(" ".join(words) + "\n")
    return root


def _ref():
    from distributed_machine_learning_tpu.data import text as ref

    return ref


def test_loader_matches_reference(corpus_dir):
    ref = _ref()
    for args in ((corpus_dir,), (corpus_dir / "a.txt",), (corpus_dir, 1000)):
        got, want = text.load_corpus(*args), ref.load_corpus(*args)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
    corpus = text.load_corpus(corpus_dir)
    assert corpus[0] == text.BOS and (corpus == text.BOS).sum() == 5  # 4 files + 1
    with pytest.raises(FileNotFoundError, match="no text files"):
        text.load_corpus(corpus_dir / "b" / "c", exts=(".rst",))
    for frac, min_eval in ((0.1, 0), (0.1, SEQ + 1), (0.5, 0), (0.1, len(corpus))):
        for g, w in zip(text.split_corpus(corpus, frac, min_eval),
                        ref.split_corpus(corpus, frac, min_eval)):
            np.testing.assert_array_equal(g, w)
    train, held = text.split_corpus(corpus, 0.1, len(corpus))  # the degrade path
    assert len(train) == len(held) == len(corpus)
    with pytest.raises(ValueError, match="eval_frac must be in"):
        text.split_corpus(corpus, 1.0)
    for rank, world in ((0, 1), (0, 2), (1, 2), (2, 3)):
        mine = iter(text.TextWindowLoader(corpus, BATCH, SEQ, seed=5, rank=rank, world=world))
        theirs = iter(ref.TextWindowLoader(corpus, BATCH, SEQ, seed=5, rank=rank, world=world))
        for _ in range(3):
            for g, w in zip(next(mine), next(theirs)):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="rank 2 outside world 2"):
        text.TextWindowLoader(corpus, BATCH, SEQ, rank=2, world=2)
    for g, w in zip(text.eval_windows(corpus, BATCH, SEQ, 3),
                    ref.eval_windows(corpus, BATCH, SEQ, 3)):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def test_cli_data_dir_matches_reference(corpus_dir, monkeypatch, capsys):
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.lm_step import (
        init_lm_state,
        make_lm_eval_step,
        make_lm_train_step,
    )
    from distributed_machine_learning_tpu.train.loop import evaluate_lm
    from distributed_machine_learning_tpu_torch.cli import lm as cli_lm
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

    ref = _ref()
    model = RefLM(vocab_size=ref.VOCAB_SIZE, d_model=32, n_layers=1, n_heads=4,
                  n_kv_heads=2)
    state = init_lm_state(model, seed=69143, config=AdamWConfig())
    weights = flax_to_state_dict(jax.device_get(state.params))
    train, held = ref.split_corpus(ref.load_corpus(corpus_dir), 0.1, SEQ + 1)
    step = make_lm_train_step(model)
    want_losses = []
    for (x, y), _ in zip(ref.TextWindowLoader(train, BATCH, SEQ, seed=69143), range(STEPS)):
        state, loss = step(state, x, y)
        want_losses.append(float(loss))
    want_nll, _ = evaluate_lm(make_lm_eval_step(model), state.params,
                              ref.eval_windows(held, BATCH, SEQ, 2))

    init = cli_lm.init_lm_state

    def converted_init(model, seed, config):
        st = init(model, seed=seed, config=config)
        model.load_state_dict(weights)
        return st

    got_losses, got_eval = [], []
    train_epoch, evaluate = cli_lm.train_epoch, cli_lm.evaluate_lm

    def recording_epoch(step, state, batches, **kw):
        def run(s, x, y):
            s, loss = step(s, x, y)
            got_losses.append(float(loss))
            return s, loss
        return train_epoch(run, state, batches, **kw)

    monkeypatch.setattr(cli_lm, "init_lm_state", converted_init)
    monkeypatch.setattr(cli_lm, "train_epoch", recording_epoch)
    monkeypatch.setattr(cli_lm, "evaluate_lm",
                        lambda *a: got_eval.append(evaluate(*a)) or got_eval[-1])
    cli_lm.main(["--device", "cpu", "--d-model", "32", "--n-layers", "1", "--n-heads", "4",
                 "--n-kv-heads", "2", "--seq-len", str(SEQ), "--batch-size", str(BATCH),
                 "--max-iters", str(STEPS), "--data-dir", str(corpus_dir),
                 "--eval-batches", "2"])
    out = capsys.readouterr().out
    assert "--data-dir is byte-level: vocab 256 -> 257" in out
    assert f"{len(held)} held-out eval tokens" in out and "Eval: nll/token" in out
    np.testing.assert_allclose(got_losses, want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_eval[0][0], want_nll, rtol=LOSS_RTOL)
