"""The CATER classifier path in the port against the JAX package.

* The label lists: ``convert_multilabel`` and ``load_cater_labels``;
* a corpus written by JAX's ``write_synthetic_cater`` (4 + 4 episodes of
  6 frames) read by both ``CaterEpisodes``: train and val batches bit
  for bit;
* the port's writer: JAX's reader reads its layout with the same
  batches as the port's, and its episodes are the max of the two
  Sprites clips its generator draws, labelled by JAX's rule;
* the metrics on logits with ties (ranked mAP, top-5, the reference's
  threshold precision) to 1e-6;
* ``FeatureClassifier`` (GRU 8 over (2, 3, 12) features, 5 classes): the
  logits to 1e-5 max abs, the loss and metrics to 1e-5 relative, every
  gradient leaf to 1e-4 of its norm;
* the two optimizers against optax over two steps (one clipped):
  ``world_model_optimizer`` (clip 100, AdamW eps 1e-5, weight decay
  1e-6) against ``chain(clip_by_global_norm(100), adamw)``, and the
  classifier's Adam against ``optax.adam``, parameters to 1e-6 max abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (assert_leaves_close, load_typed, max_abs,
                             np32, t32, typed_grads)
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.sprite.data import sprites_batch
from ode_rl_torch.wm import cater, classifier
from ode_rl_torch.wm.world_model import world_model_optimizer


def test_label_lists_match_jax(tmp_path):
    from ode_rl_tpu.wm import cater as jax_cater
    path = tmp_path / "train.txt"
    path.write_text("a.npy 3,7\n\nb.npy 0\nc.npy 9,1,4\n")
    ours, ref = (cater.load_cater_labels(path, 10),
                 jax_cater.load_cater_labels(path, 10))
    assert sorted(ours) == sorted(ref) == ["a.npy", "b.npy", "c.npy"]
    for k in ref:
        assert np.array_equal(ours[k], ref[k]) and ours[k].dtype == np.float32
    assert np.array_equal(cater.convert_multilabel(["2", 5], 6),
                          jax_cater.convert_multilabel(["2", 5], 6))


def _batches_equal(ours, ref, n: int = 3) -> None:
    for _ in range(n):
        a, b = next(ours), next(ref)
        assert a["n_chunks"] == b["n_chunks"] == 2
        for k in ("image", "label"):
            assert a[k].dtype == torch.float32
            assert np.array_equal(np32(a[k]), np.asarray(b[k])), k


def test_jax_corpus_gives_bit_equal_batches(tmp_path):
    from ode_rl_tpu.wm import cater as jax_cater
    jax_cater.write_synthetic_cater(tmp_path, n_train=4, n_val=4,
                                    n_frames=6, seed=3)
    for split, seed in (("train", 5), ("val", 0)):
        ours = cater.CaterEpisodes(tmp_path, split, 3, 3, seed=seed)
        ref = jax_cater.CaterEpisodes(tmp_path, split, 3, 3, seed=seed)
        assert len(ours) == len(ref) == 1
        _batches_equal(ours, ref)


def test_port_writer_layout_reads_in_jax(tmp_path):
    from ode_rl_tpu.wm import cater as jax_cater
    cater.write_synthetic_cater(tmp_path, n_train=4, n_val=4, n_frames=6,
                                seed=3)
    assert sorted(p.name for p in (tmp_path / "videos").iterdir()) == [
        f"cater_{i:05d}.npy" for i in range(8)]
    _batches_equal(cater.CaterEpisodes(tmp_path, "train", 2, 3, seed=1),
                   jax_cater.CaterEpisodes(tmp_path, "train", 2, 3, seed=1))
    # The episodes: the max of the two clips the generator draws, in
    # uint8; the labels: the actions and 4 + the colours present.
    noise = Noise(torch.Generator().manual_seed(3))
    v1, a1, c1 = sprites_batch(noise, 8, 6, torch.device("cpu"))
    v2, a2, c2 = sprites_batch(noise, 8, 6, torch.device("cpu"))
    u8 = ((torch.maximum(v1, v2).numpy() + 0.5) * 255).clip(0, 255).astype(
        np.uint8)
    labels = {**cater.load_cater_labels(
        tmp_path / "lists/actions_present/train.txt", 10),
        **cater.load_cater_labels(
            tmp_path / "lists/actions_present/val.txt", 10)}
    for i in range(8):
        name = f"cater_{i:05d}.npy"
        video = np.load(tmp_path / "videos" / name)
        assert video.dtype == np.uint8 and video.shape == (6, 64, 64, 3)
        assert np.array_equal(video, u8[i])
        ids = {int(a1[i]), int(a2[i]), 4 + int(c1[i]), 4 + int(c2[i])}
        assert set(np.flatnonzero(labels[name])) == ids


def test_metrics_with_ties_match_jax():
    from ode_rl_tpu.wm import classifier as jc
    rng = np.random.RandomState(0)
    # Scores on a coarse grid, so many tie within a class and within a
    # sample; one class with no positive.
    logits = rng.randint(-2, 3, (12, 7)).astype(np.float32)
    labels = (rng.rand(12, 7) > 0.6).astype(np.float32)
    labels[:, 3] = 0.0
    for k in (1, 5, 9):
        assert abs(float(classifier.top_k_accuracy(
            t32(logits), t32(labels), k)) - float(jc.top_k_accuracy(
                logits, labels, k))) <= 1e-6
    for ours, ref in (
            (classifier.mean_average_precision(t32(logits), t32(labels)),
             jc.mean_average_precision(logits, labels)),
            (classifier.reference_map_precision(t32(logits), t32(labels)),
             jc.reference_map_precision(logits, labels)),
            (classifier.reference_map_precision(
                torch.sigmoid(t32(logits)), t32(labels), from_logits=False),
             jc.reference_map_precision(jax.nn.sigmoid(logits), labels,
                                        from_logits=False))):
        assert abs(float(ours) - float(ref)) <= 1e-6
    # A descending sort that broke ties otherwise would disagree here.
    flat = np.zeros((4, 6), np.float32)
    flat_labels = np.eye(4, 6, 5, dtype=np.float32)
    assert float(classifier.top_k_accuracy(t32(flat), t32(flat_labels),
                                           5)) == float(jc.top_k_accuracy(
                                               flat, flat_labels, 5)) == 0.0


def test_feature_classifier_matches_jax():
    from ode_rl_tpu.wm.classifier import FeatureClassifier as JaxClf
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 3, 12).astype(np.float32)
    labels = (rng.rand(2, 5) > 0.5).astype(np.float32)
    jm = JaxClf(n_classes=5, hidden=8)
    variables = jm.init(jax.random.key(0), feats)
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, feats, labels, method=jm.loss),
        has_aux=True)(variables["params"])
    port = classifier.FeatureClassifier(12, 5, hidden=8,
                                        generator=torch.Generator())
    load_typed(port, variables["params"])
    assert max_abs(port(t32(feats)), jm.apply(variables, feats)) <= 1e-5
    loss, metrics = port.loss(t32(feats), t32(labels))
    for k, v in j_metrics.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-5 * max(
            abs(float(v)), 1e-2), k
    loss.backward()
    assert_leaves_close({n: p.grad for n, p in port.named_parameters()},
                        typed_grads(port, j_grads), 1e-4)


@pytest.mark.parametrize("which", ["world_model_adamw", "classifier_adam"])
def test_optimizers_match_optax(which):
    import optax
    from ode_rl_tpu.wm.world_model import world_model_optimizer as jax_opt
    rng = np.random.RandomState(2)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    # The first gradient's global norm is above 100 (clipped), the
    # second's below.
    grads = [{k: (300.0 * rng.randn(*v.shape)).astype(np.float32)
              for k, v in params.items()},
             {k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()}]
    tx = jax_opt(3e-4) if which == "world_model_adamw" else optax.adam(1e-3)
    jp, state = jax.tree_util.tree_map(jnp.asarray, params), None
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t32(v)) for k, v in params.items()}
    if which == "world_model_adamw":
        opt = world_model_optimizer(tp.values(), 3e-4)
    else:
        opt = torch.optim.Adam(tp.values(), lr=1e-3, betas=(0.9, 0.999),
                               eps=1e-8)
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = t32(g[k])
        opt.step()
        for k in params:
            assert max_abs(tp[k].detach(), jp[k]) <= 1e-6, k
