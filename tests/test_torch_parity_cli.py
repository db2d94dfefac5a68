"""The port's parity harness (``cli/parity.py``) against the JAX package's:
the same reference table, the same parse of a part's printed lines, the
same report rows and columns, and the equivalence identities at W 2
(gloo ranks on the CPU, VGGTEST, small batches)."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest

from distributed_machine_learning_tpu_torch.cli import parity as tparity

SMALL = ["--device", "cpu", "--model", "vggtest", "--max-iters", "2", "--batch-size", "8",
         "--eval-batches", "1", "--eval-batch-size", "16", "--num-nodes", "2"]


def _table(print_table, rows) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        print_table(rows)
    return buf.getvalue()


def test_report_rows_and_columns_match_jax(tmp_path):
    from distributed_machine_learning_tpu.cli import parity as jparity

    assert tparity.REFERENCE == jparity.REFERENCE
    sample = ("Total execution time is : 1.5 seconds\nAverage execution time is  : 0.5 "
              "seconds\nTest set: Average loss: 2.3031, Accuracy: 1000/10000 (10%)\n")
    assert tparity._parse_output(sample) == jparity._parse_output(sample)
    out = tmp_path / "rows.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        tparity.main([*SMALL, "--json", str(out)])
    rows = json.loads(out.read_text())
    assert [r["part"] for r in rows] == ["part1", "part2a", "part2b", "part3"]
    assert [r["world"] for r in rows] == [1, 2, 2, 2]
    assert all(r["data"] == "synthetic" and r["max_iters"] == 2 for r in rows)
    assert all(set(r) == {"part", "data", "world", "max_iters", "reference", "measured"}
               for r in rows)
    assert set(rows[0]["measured"]) == {"total_s", "avg_iter_s", "avg_test_loss",
                                        "accuracy_pct"}
    assert all(set(r["measured"]) >= {"total_s", "avg_iter_s"} for r in rows)
    # The same rows print the same table through either harness.
    assert _table(tparity.print_table, rows) == _table(jparity.print_table, rows)
    assert _table(tparity.print_table, rows) in buf.getvalue()


def test_equivalence_holds_at_world_2(tmp_path):
    out = tmp_path / "eq.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        tparity.main([*SMALL, "--equivalence", "--json", str(out)])
    result = json.loads(out.read_text())
    assert result["ok"] and result["world"] == 2 and result["global_batch"] == 16
    assert list(result["checks"]) == ["part2a==part2b", "part2b==part1@lr*2", "part3==part1"]
    assert "PASS  part3==part1" in buf.getvalue()


def test_equivalence_refuses_a_world_of_one():
    with pytest.raises(ValueError, match="needs >= 2 ranks"):
        tparity.main(["--device", "cpu", "--equivalence", "--num-nodes", "1"])
    with pytest.raises(ValueError, match="unknown part"):
        tparity.main(["--device", "cpu", "--parts", "part1,part9"])
