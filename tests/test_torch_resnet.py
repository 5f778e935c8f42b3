"""ResNet-D backbone: spotter_tpu_torch.models.resnet against spotter_tpu.models.resnet.

Basic (R18/34-style) and bottleneck (R50/101-style) stacks at small widths,
with flax params from a numpy seed carried across by `convert.from_jax`.
The bottleneck config has depths (1, 1, 2, 1): its stride-2 stages take
the "avgpool_proj" shortcut, and the 72x72 input makes a stage input odd
(9x9), so the ceil-mode average pool's clipped edge windows are exercised.

Tolerance atol 1e-4, rtol 1e-4: fp32 on both sides through up to 16 convs
whose sums run in another order.
"""

import numpy as np
import pytest
import torch

from spotter_tpu.models.configs import ResNetConfig as JResNetConfig
from spotter_tpu.models.resnet import ResNetBackbone as JBackbone
from spotter_tpu_torch.convert.from_jax import load_from_jax
from spotter_tpu_torch.models.configs import ResNetConfig
from spotter_tpu_torch.models.resnet import ResNetBackbone, avg_pool_2x2_ceil
from tests.torch_parity import random_flax_params

CONFIGS = {
    "basic": dict(
        embedding_size=16, hidden_sizes=(16, 24, 32, 48), depths=(1, 2, 1, 1), layer_type="basic"
    ),
    "bottleneck": dict(
        embedding_size=16, hidden_sizes=(32, 48, 64, 96), depths=(1, 1, 2, 1),
        layer_type="bottleneck",
    ),
}


@pytest.mark.parametrize("kind", sorted(CONFIGS))
@pytest.mark.parametrize("hw", [(64, 64), (72, 72)])
def test_backbone_matches_jax(kind, hw):
    x = np.random.default_rng(0).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jmod = JBackbone(JResNetConfig(**CONFIGS[kind]))
    params = random_flax_params(jmod, x[:1], seed=1)
    want = jmod.apply({"params": params}, x)
    tmod = load_from_jax(ResNetBackbone(ResNetConfig(**CONFIGS[kind])).eval(), params)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    assert tmod.out_channels == tuple(w.shape[-1] for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_avg_pool_ceil_divides_by_window_count():
    x = torch.arange(9, dtype=torch.float32).reshape(1, 1, 3, 3)
    got = avg_pool_2x2_ceil(x)[0, 0]
    want = torch.tensor([[(0 + 1 + 3 + 4) / 4, (2 + 5) / 2], [(6 + 7) / 2, 8.0]])
    torch.testing.assert_close(got, want)
