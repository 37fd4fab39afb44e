"""K3/K4's twins at the shapes whose trunk input leaves shared memory in
some of K1-K4 (ROADMAP B.1.2: 8 x 512, nine layers, eight kp bands and
16 x 512 at ten kp bands, each at S=16) against anerf_tpu's Pallas
custom_vjps on the CPU, at the bars and by the method
``test_torch_encmlp_shapes_bwd.py`` sets out (the 512-wide nets at
cosine and norm, the 16 x 512 corner at bars from the two evaluations'
distances to an f64 evaluation of its chain); its file holds the
resident shapes' cases.
"""
import pytest

from test_torch_encmlp_shapes import B12_SHAPES, BWD_CASES
from test_torch_encmlp_shapes_bwd import check_bwd_case
from test_torch_threads import one_torch_thread  # noqa: F401

B12_CASES = [(n, S) for n, S in BWD_CASES if n in B12_SHAPES]


@pytest.mark.parametrize('name,S', B12_CASES,
                         ids=[f'{n}-{S}' for n, S in B12_CASES])
def test_bwd_twins_match_pallas_vjp(name, S):
    """K4's twin at S=64 (both nets on the coarse samples) and K3's at
    S=16 (the fine net on the importance samples)."""
    check_bwd_case(name, S)
