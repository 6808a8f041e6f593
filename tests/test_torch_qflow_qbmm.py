"""``qbmm`` with BFP operands (the qflow currency) against the JAX package.

Kinds pp (both operands pre-quantized), iq (``a``) and qi (``b``): the
value and both gradients ``==`` ``jax.vjp`` of the JAX ``qbmm``, under
``kernel_mode="auto"`` and ``"fused"`` (the JAX side's Pallas kernels in
interpret mode), with the decisions of the forward and both backward
contractions.  The helpers are ``test_torch_qflow.py``'s.
"""

import jax
import numpy as np
import pytest

from repro.core import qops as jqops
from repro.core.policy import NumericPolicy as JaxPolicy
from repro_torch.core import prng, qops
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd
from test_torch_qflow import MODES, _check, _f32, _jq, _tq


# kinds of the forward contraction: both operands BFP (pp), a BFP (iq),
# b BFP (qi)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("a_q,b_q,kind", [(True, True, "pp"),
                                          (True, False, "iq"),
                                          (False, True, "qi")])
def test_qbmm_bfp_operands_equal_jax(mode, a_q, b_q, kind):
    rng = np.random.RandomState(5)
    a, b = _f32(rng, 2, 3, 7, 19), _f32(rng, 2, 3, 19, 11, scale=0.5)
    ct = _f32(rng, 2, 3, 7, 11)
    jpol = JaxPolicy(qflow=True, kernel_mode=mode)
    tpol = NumericPolicy(qflow=True, kernel_mode=mode)

    def jfn(a, b):
        ain = _jq(a, jax.random.key(11)) if a_q else a
        bin_ = _jq(b, jax.random.key(12)) if b_q else b
        return jqops.qbmm(ain, bin_, jax.random.key(9), jpol), ()

    def tfn(a, b):
        ain = _tq(a, prng.key(11)) if a_q else a
        bin_ = _tq(b, prng.key(12)) if b_q else b
        return qops.qbmm(ain, bin_, prng.key(9), tpol), ()

    with kd.record_decisions() as log:
        _check(jfn, tfn, (a, b), ct)
    want = {"auto": kd.JNP, "fused": kd.FUSED}[mode]
    assert [(d.op, d.kind, d.path) for d in log] == [
        ("qbmm_fwd", kind, want), ("qbmm_dx", "qi", want),
        ("qbmm_dw", "ii", want)]
