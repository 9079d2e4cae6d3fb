"""The Mixtral train step at tp x ep in the port, on four gloo ranks on
the CPU (one world, each step at its own layout), against the JAX package's
GSPMD step on a 4-device mesh from the same numpy-seeded weights and
batches: tp=2 x dp=2 x ep=2 and tp=1 x dp=4 x ep=4 (dp_exp=1), blockwise
and capacity dispatch, with ZeRO-1, and every synchronised gradient
against ``jax.grad`` of the dense loss (``tests/jax_ep_refs.py`` holds the
world, the references and the tolerances;
``tests/test_torch_mixtral_ep_dpexp.py`` runs dp_exp=2). The local expert
banks are ``[E/ep, H, 2, I/tp]``. The world runs on a thread beside the
JAX references; the two dispatch modes of a layout compile on threads of
their own."""

import pytest

import jax_ep_refs as refs

LAYOUTS = {"tp2_ep2": (2, 2), "tp1_ep4": (1, 4)}
STEPS = refs.steps(LAYOUTS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return refs.step_world(
        LAYOUTS, str(tmp_path_factory.mktemp("mixtral_ep_step")))


def test_ranks_import_no_jax(world):
    refs.assert_ranks_import_no_jax(world)


@pytest.mark.parametrize("name,dispatch,layout", STEPS)
def test_train_step_at_tp_ep_matches_jax_gspmd(world, name, dispatch,
                                               layout):
    """Every rank reports JAX's loss and grad norm at both steps; the
    ranks' shards gathered equal JAX's updated params, each of which
    moved; the expert banks are ``[E/ep, H, 2, I/tp]``; ranks that hold
    the same shards end equal."""
    refs.assert_step_matches(world, name, layout)


@pytest.mark.parametrize("name,dispatch,layout", STEPS)
def test_synchronised_gradients_match_jax_grad(world, name, dispatch,
                                               layout):
    """Each synchronised gradient (shards gathered), the experts' and the
    router's included, equals ``jax.grad`` of the dense loss over the
    global batch within 1e-4 x max|g|."""
    refs.assert_grads_match(world, name, dispatch)
