"""The port's MLP against the reference's ``layers.mlp`` on the same
weights, for each activation: ``silu`` (swiglu), ``gelu`` (geglu) and
``gelu_plain`` (whisper's ungated MLP).

``jax.nn.gelu`` defaults to the tanh form; the exact erf form differs from
it by up to 4.7e-4 over [-4, 4], the tanh form of ``F.gelu`` by under 1e-6.
So the outputs are held to 1e-5 max abs in float32: an erf GELU fails it.
Two weight sets: identities (the output is the activation itself, over
inputs spread across [-4, 4]) and the reference's own init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5
D = 64


def mlp_pair(act: str, weights: str):
    p = JL.init_params(JL.mlp_specs(D, D, act), jax.random.PRNGKey(0))
    if weights == "identity":
        p = jax.tree.map(lambda w: jnp.eye(D, dtype=jnp.float32), p)
    m = TL.MLP(D, D, act, generator=torch.Generator().manual_seed(0),
               device="cpu", dtype=torch.float32)
    m.load_state_dict({f"{name}.w": torch.from_numpy(np.array(sub["w"]))
                       for name, sub in p.items()})
    return p, m


@pytest.mark.parametrize("weights", ["identity", "init"])
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_plain"])
def test_mlp_matches_reference(act, weights):
    p, m = mlp_pair(act, weights)
    x = np.linspace(-4.0, 4.0, 32 * D, dtype=np.float32).reshape(2, 16, D)
    want = np.asarray(JL.mlp(p, jnp.asarray(x), act))
    got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL
    assert (m.wg is None) == (act == "gelu_plain")


def test_gelu_is_the_tanh_form():
    """The port's GELU is ``jax.nn.gelu``'s default (tanh) form: within
    1e-6 of it over [-4, 4], while the erf form lies 4e-4 away."""
    x = np.linspace(-4.0, 4.0, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = TL.gelu(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert float(np.abs(erf - want).max()) > 4e-4
