"""``quant.convert.quantize_tree`` on a tree that lies on the card against the
native C++ quantizers on the host (``quant.native_bridge.quantize_native``,
the converter's), bit for bit, at the full-width DiT's linear shapes in all
four formats (a 4-bit format keeps q8_0 at K = 384, ``proj_in``).

Every test needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_convert.py -q
"""

import pytest
import torch

from acestep_tpu_torch.quant import QUANT_FORMATS, QuantTensor, supported_format_for
from acestep_tpu_torch.quant.convert import quantize_tree
from acestep_tpu_torch.quant.native_bridge import quantize_native

pytestmark = pytest.mark.cuda

# (K, N) of the 2048 x 24 DiT's linears: q / o / cross, k / v, gate / up, down,
# proj_in (K = 192 x 2)
DIT_SHAPES = ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048), (384, 2048))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's quantizers run there)")
    return torch.device("cuda")


@pytest.mark.parametrize("fmt", QUANT_FORMATS)
def test_quantize_tree_on_the_card_equals_native(dev, fmt):
    g = torch.Generator().manual_seed(3)
    tree = {"layers": [{"proj": {"kernel": (torch.randn(k, n, generator=g) * 0.02).bfloat16()}}
                       for k, n in DIT_SHAPES]}
    got = quantize_tree({"layers": [{"proj": {"kernel": layer["proj"]["kernel"].to(dev)}}
                                    for layer in tree["layers"]]}, fmt)
    for (k, n), layer, src in zip(DIT_SHAPES, got["layers"], tree["layers"]):
        qt = layer["proj"]["kernel"]
        assert isinstance(qt, QuantTensor) and qt.fmt == supported_format_for(k, fmt)
        assert qt.data.device.type == "cuda"
        want = quantize_native(src["proj"]["kernel"].float().numpy(), qt.fmt)
        assert set(want.fields()) == set(qt.fields())
        for f, a in want.fields().items():
            assert torch.equal(getattr(qt, f).cpu(), a), f"{qt.fmt} {k}x{n} {f}"
