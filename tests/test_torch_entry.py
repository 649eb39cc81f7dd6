"""``vaegan_tpu_torch.entry.entry()`` against ``__graft_entry__.entry()``: the
flagship generator's eval forward at 96², batch 4, with the JAX entry's weights
carried over by ``from_jax_variables``; the reconstructions agree within 1e-4."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from vaegan_tpu_torch.entry import entry
from vaegan_tpu_torch.interop import from_jax_variables
from vaegan_tpu_torch.models import ResBlockVAE

torch.set_num_threads(1)


def test_entry_forward_matches_jax():
    import jax

    jfn, (variables, zeros) = jentry.entry()
    forward, (gen, example) = entry(device="cpu")
    assert tuple(example.shape) == tuple(zeros.shape) == (4, 96, 96, 1)
    fused = [m.use_pallas for m in gen.modules() if isinstance(m, ResBlockVAE)]
    assert fused and all(fused)    # every res-block's BN sites run row 1
    gen.load_state_dict(from_jax_variables(variables), strict=True)
    batch = np.random.default_rng(0).random((4, 96, 96, 1), dtype=np.float32)
    want = np.asarray(jax.jit(jfn)(variables, batch))
    got = forward(gen, torch.from_numpy(batch)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-4)
    assert np.isfinite(forward(gen, example).numpy()).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_entry_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
