"""The port's BinaryPredictor against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.serve import BinaryPredictor as JaxPredictor
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.serve import BinaryPredictor
from pranet2_tpu_torch.utils.convert import load_jax_variables
from test_torch_port_pranet import random_variables

TESTSIZE, BATCH = 64, 2


@pytest.fixture(scope="module")
def weights():
    v = random_variables(jax_get_model("pranet_v2", num_class=1),
                         jnp.zeros((1, TESTSIZE, TESTSIZE, 3)), seed=5)
    port = load_jax_variables(get_model("pranet_v2", device="cpu"), v)
    return v, port.state_dict()


def _images(n):
    rng = np.random.default_rng(4)
    return [(rng.random((40 + 7 * i, 50 + 3 * i, 3)) * 255).astype(np.uint8)
            for i in range(n)]


@pytest.mark.parametrize("exact_postproc", [True, False])
def test_predictor_matches_jax(weights, exact_postproc):
    """Three images of different native sizes at batch 2: one full batch
    and one padded partial batch."""
    v, sd = weights
    images = _images(3)
    port = BinaryPredictor("pranet_v2", sd, batch_size=BATCH,
                           testsize=TESTSIZE, exact_postproc=exact_postproc,
                           device="cpu")
    want = JaxPredictor("pranet_v2", v, batch_size=BATCH, testsize=TESTSIZE,
                        exact_postproc=exact_postproc)(images)
    got = port(images)
    port.close()
    assert len(got) == len(want) == 3
    for im, g, w in zip(images, got, want):
        assert g.shape == im.shape[:2] and g.dtype == np.uint8
        # f32 logits agree to ~1e-6 relative; a pixel on a uint8
        # quantisation boundary may land one level apart
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1, diff.max()


def test_stream_matches_batch_call(weights):
    _, sd = weights
    images = _images(5)
    port = BinaryPredictor("pranet_v2", sd, batch_size=BATCH,
                           testsize=TESTSIZE, host_workers=0, device="cpu")
    streamed = list(port.stream(iter(images)))
    called = port(images)
    assert len(streamed) == len(called) == 5
    for a, b in zip(streamed, called):
        np.testing.assert_array_equal(a, b)
