"""``cli.lm --parallel ep`` on 4 gloo ranks vs the JAX package, on the CPU:
einsum EP on a (2, 2) (batch, expert) mesh (the Switch capacity of the
global batch, each token's queue place counted across the data ranks) and
``--moe-impl grouped --ep-seq 2`` on a (1, 2, 2) (batch, expert, seq) mesh
with ring attention over the sequence (MoE × context parallelism, L 64 in
chunks of 32).  One spawn of 4 ranks runs both; the checks, tolerances and
reference steps are ``tests/test_torch_ep.py``'s (``check_case``).
"""

import pytest

from test_torch_ep import check_case


@pytest.mark.parametrize("case", ["einsum-2x2", "grouped-seq-1x2x2"])
def test_three_steps_match_reference(case):
    check_case(case)
