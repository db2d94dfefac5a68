"""The kernel build's cache key and the ``--perturb`` faults, on the CPU.

``ops/build.py`` names each library by a hash of its source, of every
shared header under ``csrc/`` and of the flags, so that an edited header
is never served by a stale build.  These tests write sources to a
temporary ``CSRC`` and need no nvcc.
"""

import importlib.util
from pathlib import Path

import pytest

from distributed_machine_learning_tpu_torch.ops import build

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\nextern "C" int a() { return f(); }\n')
    (tmp_path / "b.cu").write_text('extern "C" int b() { return 2; }\n')
    (tmp_path / "shared.cuh").write_text("inline int f() { return 1; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_target_is_stable(csrc):
    assert build._target("a") == build._target("a")
    assert build._target("a") != build._target("b")
    assert build._target("a").name.startswith("liba-")


def test_editing_a_header_changes_every_target(csrc):
    before = {n: build._target(n) for n in ("a", "b")}
    (csrc / "shared.cuh").write_text("inline int f() { return 3; }\n")
    after = {n: build._target(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
    (csrc / "shared.cuh").write_text("inline int f() { return 1; }\n")
    assert {n: build._target(n) for n in ("a", "b")} == before


def test_adding_a_header_changes_the_target(csrc):
    before = build._target("a")
    (csrc / "other.cuh").write_text("// another shared header\n")
    assert build._target("a") != before


def test_editing_the_source_or_the_flags_changes_the_target(csrc, monkeypatch):
    before = build._target("a")
    (csrc / "a.cu").write_text('#include "shared.cuh"\nextern "C" int a() { return -f(); }\n')
    edited = build._target("a")
    assert edited != before
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._target("a") != edited


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_perturbation_names_text_found_once():
    """``--perturb`` refuses a fault whose text is missing; each must match
    exactly one place of the file it names, and name a kernel that builds."""
    smoke = _chip_smoke()
    for name, (kernel, old, new, *where) in smoke.PERTURBATIONS.items():
        assert kernel in build.SOURCES, name
        text = (build.CSRC / (where[0] if where else f"{kernel}.cu")).read_text()
        assert text.count(old) == 1, name
        assert old != new, name
