"""The Mixtral train step at tp=1 x dp=4 x ep=2 in the port (dp_exp=2:
an expert gradient summed over dp_exp and divided by dp, the expert
moments' ZeRO-1 over dp_exp), on four gloo ranks on the CPU, against the
JAX package's GSPMD step on a 4-device mesh from the same numpy-seeded
weights and batches, blockwise and capacity dispatch, and every
synchronised gradient against ``jax.grad`` of the dense loss
(``tests/jax_ep_refs.py`` holds the world, the references and the
tolerances). A file of its own beside
``tests/test_torch_mixtral_ep_step.py``, so that neither file's world
holds up a test worker for long."""

import pytest

import jax_ep_refs as refs

LAYOUTS = {"tp1_ep2": (1, 2)}
STEPS = refs.steps(LAYOUTS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return refs.step_world(
        LAYOUTS, str(tmp_path_factory.mktemp("mixtral_ep_dpexp")))


def test_ranks_import_no_jax(world):
    refs.assert_ranks_import_no_jax(world)


@pytest.mark.parametrize("name,dispatch,layout", STEPS)
def test_train_step_at_tp_ep_matches_jax_gspmd(world, name, dispatch,
                                               layout):
    """Every rank reports JAX's loss and grad norm at both steps; the
    ranks' shards gathered equal JAX's updated params, each of which
    moved; the expert banks are ``[E/2, H, 2, I]``; ranks that hold the
    same shards (the two dp_exp ranks of an ep rank) end equal."""
    refs.assert_step_matches(world, name, layout)


@pytest.mark.parametrize("name,dispatch,layout", STEPS)
def test_synchronised_gradients_match_jax_grad(world, name, dispatch,
                                               layout):
    """Each synchronised gradient (shards gathered), the experts' and the
    router's included, equals ``jax.grad`` of the dense loss over the
    global batch within 1e-4 x max|g|."""
    refs.assert_grads_match(world, name, dispatch)
