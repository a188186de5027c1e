"""PyTorch port on the card: each CUDA kernel against its plain twin, and the
served logits against the plain path. Skipped without a CUDA device; on a
machine with one (which need not have JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as ta
from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion as tf

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("seq,hd", [(72, 64), (512, 64), (40, 16), (24, 128)])
def test_packed_attention_kernel_matches_twin(card, seq, hd):
    g = torch.Generator().manual_seed(seq)
    heads = 4
    qkv = torch.randn(4, seq, 3 * heads * hd, generator=g).to(card)
    lengths = torch.tensor([0, seq, 37 % seq, seq - 7], dtype=torch.int32, device=card)
    before = ta.packed_attention_fwd.launches
    out, lse = ta.packed_attention_fwd(qkv, lengths, heads, hd**-0.5)
    torch.cuda.synchronize()
    assert ta.packed_attention_fwd.launches == before + 1
    ref_out, ref_lse = ta.packed_attention_reference(qkv, lengths, heads, hd**-0.5)
    # f32 both; the kernel's online softmax sums over 64-key tiles
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    assert torch.all(out[0] == 0) and torch.all(lse[0] == ta.NEG_INF)


def test_packed_attention_kernel_rejects_what_it_does_not_take(card):
    qkv = torch.zeros(2, 8, 3 * 4 * 8, device=card)  # head_dim 8
    lengths = torch.full((2,), 8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        ta.packed_attention_fwd(qkv, lengths, 4, 1.0)
    with pytest.raises(TypeError, match="int32"):
        ta.packed_attention_fwd(torch.zeros(2, 8, 3 * 64, device=card), lengths.long(), 1, 1.0)


@pytest.mark.parametrize("batch", [1, 5, 64])
def test_fused_head_kernel_matches_twin(card, batch):
    g = torch.Generator().manual_seed(batch)
    num_mod, hidden, ncls = 4, 256, 25
    pairs = [(q, k) for q in range(num_mod) for k in range(num_mod) if q != k]
    p = len(pairs)

    def w(*shape, scale=0.06):
        return (torch.randn(*shape, generator=g) * scale).to(card)

    projected = torch.relu(w(num_mod, batch, hidden, scale=1.0))
    mask = (torch.rand(batch, num_mod, generator=g) > 0.4).float().to(card)
    mask[0] = 0.0
    pair_params = {"value_kernel": w(p, hidden, hidden), "value_bias": w(p, hidden),
                   "out_kernel": w(p, hidden, hidden), "out_bias": w(p, hidden)}
    rest = (w(num_mod, hidden), w(num_mod), w(hidden, hidden), w(hidden),
            w(hidden, ncls), w(ncls))
    before = tf.fused_hybrid_head.launches
    got = tf.fused_hybrid_head(projected, mask, pair_params, *rest, pairs)
    torch.cuda.synchronize()
    assert tf.fused_hybrid_head.launches == before + 1
    want = tf.fused_hybrid_head_reference(projected, mask, pair_params, *rest, pairs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
