"""The tiny LC model with CNW linear fusion with dual queries: the port against the JAX package.

Head outputs, decoded boxes, every loss term and every parameter's gradient
under the forced flag pairs (1, 1), (1, 0) and (0, 1), and LC ``predict``
(tests/torch_fusion_models.py says how).  Tolerance: atol/rtol 1e-4 on the
outputs and boxes, 1e-5 relative on the losses, 1e-3 of each parameter's
largest gradient; labels, validity and zero gradients exactly.
"""

import pytest

import torch_fusion_models as fm

VARIANT = "dual"


def test_tiny_cfg_is_the_variant_held_here():
    fm.check_tiny_cfg(VARIANT)


@pytest.fixture(scope="module")
def pair_run():
    return fm.run_pair(VARIANT)


@pytest.mark.parametrize("pair", fm.FLAG_PAIRS, ids=fm.FLAG_IDS)
def test_head_outputs_and_boxes_match(pair_run, pair):
    fm.check_head_outputs(pair_run, pair)


def test_predict_matches(pair_run):
    fm.check_predict(pair_run)


@pytest.mark.parametrize("pair", fm.FLAG_PAIRS, ids=fm.FLAG_IDS)
def test_every_loss_term_matches(pair_run, pair):
    fm.check_losses(pair_run, pair)


@pytest.mark.parametrize("pair", fm.FLAG_PAIRS, ids=fm.FLAG_IDS)
def test_every_gradient_matches(pair_run, pair):
    fm.check_gradients(pair_run, pair)


def test_two_bev_query_embeddings(pair_run):
    head = pair_run["model"].pts_bbox_head
    assert head.bev_embedding_img.weight.shape == (64, 32)
    assert head.bev_embedding_pts.weight.shape == (64, 32)
    assert not hasattr(head, "bev_embedding")
