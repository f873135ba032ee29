"""sqair_tpu_torch's CUDA kernels against their plain versions on the card.

Needs a CUDA device (skips without one) and imports no JAX, so that it runs
on a machine without it; the root conftest.py imports JAX, so run it there
with ``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
Tolerance 1e-5 abs + 1e-4 rel: the same f32 sums in another order.
"""
import pytest
import torch

from sqair_tpu_torch.ops import fused


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """Each kernel against its plain version on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda") / s[0] ** 0.5

    with torch.inference_mode():
        x, h = torch.rand(100, 300, generator=gen, device="cuda"), rnd(100, 64)
        params = [(rnd(300, 256), rnd(256)), (rnd(256, 64), rnd(64))]
        for acts in (("elu", "sigmoid"), ("tanh", "id")):
            torch.testing.assert_close(fused.fused_mlp(x, params, acts),
                                       fused.mlp_plain(x, params, acts),
                                       rtol=1e-4, atol=1e-5)
        v = (x, h, rnd(300, 64), rnd(64, 64), rnd(64))
        torch.testing.assert_close(fused.fused_vanilla_rnn(*v), fused.vanilla_rnn_plain(*v),
                                   rtol=1e-4, atol=1e-5)
        g = (x, h, rnd(300, 128), rnd(64, 128), rnd(128), rnd(300, 64), rnd(64, 64), rnd(64))
        torch.testing.assert_close(fused.fused_gru(*g), fused.gru_plain(*g),
                                   rtol=1e-4, atol=1e-5)
    w = torch.zeros(300, 8, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused.fused_mlp(torch.ones(4, 300, device="cuda"), [(w, torch.zeros(8, device="cuda"))],
                        ["id"])
