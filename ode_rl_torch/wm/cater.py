"""The CATER-layout episode corpus and the classifier's train and test
paths.

Counterpart of ``ode_rl_tpu/wm/cater.py``:

* ``load_cater_labels`` reads the reference's label lists, one line an
  episode, ``<video> <id>,<id>,...``, into multi-hot targets;
* ``write_synthetic_cater`` writes ``videos/cater_<i>.npy`` (uint8 (T,
  64, 64, 3)) and ``lists/actions_present/{train,val}.txt``: each episode
  the max of two Sprites clips (sprite/data.py's ``sprites_batch``, eight
  episodes a draw), labelled with the actions (ids 0-3) and colours
  (4 + colour) present. The layout and the label rule are JAX's; the
  pixels are the port's own draws, from a generator seeded ``seed``;
* ``CaterEpisodes`` reads such a corpus: train batches are
  ``np.random.RandomState(seed).randint`` picks, val batches walk the
  list in order, so the batches equal JAX's on the same corpus; each
  episode is cut into chunks of ``batch_length`` frames folded into the
  batch axis;
* ``CaterClassifierModel`` holds the world model ``wm`` and the
  ``FeatureClassifier`` ``clf`` over each chunk's last posterior feature;
* ``train_cater_classifier`` writes the corpus where ``data_dir`` has
  none, then trains both with one forward that serves both losses (the
  classifier's BCE reaches the world model through the features) and two
  optimizers, ``world_model_optimizer`` for ``wm`` and Adam at
  ``classifier_lr`` for ``clf``; it logs every ``loss_log_freq`` steps,
  sweeps the val split (``val_metric_sweep``) and saves the two state
  dicts with the config under ``<logdir>/CATER/<id>``;
* ``eval_cater_classifier`` (``phase: test``) restores that checkpoint
  by ``ckpt_id``, builds the model from the saved config (keeping this
  run's ``batch_size``, ``data_dir``, ``seed`` and ``eval_batches``) and
  sweeps the val split.

``random_mAP_baseline`` is the mAP of standard normal logits drawn from a
generator seeded 123; it cannot equal JAX's draw from its key 123, only
its distribution. The world model draws from a generator seeded
``seed``.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from ode_rl_torch.core.noise import Noise

N_CATER_CLASSES = 10  # 4 actions + 6 colours (the Sprites vocabulary)


def convert_multilabel(ids, n_classes: int) -> np.ndarray:
    """[3, 7] -> the multi-hot (n_classes,)."""
    y = np.zeros((n_classes,), np.float32)
    for i in ids:
        y[int(i)] = 1.0
    return y


def load_cater_labels(fpath, n_classes: int) -> Dict[str, np.ndarray]:
    """``<video> <id>,<id>,...`` lines -> {video: multi-hot}."""
    out = {}
    for line in pathlib.Path(fpath).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        name, ids = line.split(" ", 1)
        out[name] = convert_multilabel(ids.split(","), n_classes)
    return out


def write_synthetic_cater(root, n_train: int = 120, n_val: int = 40,
                          n_frames: int = 40, seed: int = 0) -> pathlib.Path:
    """Write ``videos/*.npy`` and ``lists/actions_present/{train,
    val}.txt`` under ``root``."""
    from ode_rl_torch.sprite.data import sprites_batch

    root = pathlib.Path(root)
    vid_dir = root / "videos"
    list_dir = root / "lists" / "actions_present"
    vid_dir.mkdir(parents=True, exist_ok=True)
    list_dir.mkdir(parents=True, exist_ok=True)
    noise = Noise(torch.Generator().manual_seed(seed))
    cpu = torch.device("cpu")
    lines = {"train": [], "val": []}
    total, done = n_train + n_val, 0
    while done < total:
        b = min(8, total - done)
        v1, a1, c1 = sprites_batch(noise, b, n_frames, cpu)
        v2, a2, c2 = sprites_batch(noise, b, n_frames, cpu)
        video = torch.maximum(v1, v2).numpy()           # [-0.5, 0.5]
        u8 = ((video + 0.5) * 255).clip(0, 255).astype(np.uint8)
        for i in range(b):
            idx = done + i
            name = f"cater_{idx:05d}.npy"
            np.save(vid_dir / name, u8[i])
            ids = sorted({int(a1[i]), int(a2[i]), 4 + int(c1[i]),
                          4 + int(c2[i])})
            split = "train" if idx < n_train else "val"
            lines[split].append(f"{name} {','.join(map(str, ids))}")
        done += b
    for split in ("train", "val"):
        (list_dir / f"{split}.txt").write_text("\n".join(lines[split]) + "\n")
    return root


class CaterEpisodes:
    """Endless batches {"image": (B n, L, H, W, C) in [-0.5, 0.5],
    "label": (B, n_classes), "n_chunks": n} on ``device``."""

    def __init__(self, root, split: str = "train", batch_size: int = 4,
                 batch_length: int = 20, n_classes: int = N_CATER_CLASSES,
                 task: str = "actions_present", seed: int = 0,
                 device: torch.device = torch.device("cpu")):
        root = pathlib.Path(root)
        self.labels = load_cater_labels(
            root / "lists" / task / f"{split}.txt", n_classes)
        self.names = sorted(self.labels)
        if not self.names:
            raise FileNotFoundError(f"no episodes listed for {split} "
                                    f"under {root}")
        self.vid_dir = root / "videos"
        self.batch_size, self.batch_length = batch_size, batch_length
        self.n_classes, self.device = n_classes, device
        self._rng = np.random.RandomState(seed)
        self._train = split == "train"
        self._cursor = 0

    def __len__(self) -> int:
        return max(len(self.names) // self.batch_size, 1)

    def _episode(self, name: str) -> np.ndarray:
        return np.load(self.vid_dir / name).astype(np.float32) / 255.0 - 0.5

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        if self._train:
            idx = self._rng.randint(0, len(self.names), self.batch_size)
        else:
            idx = [(self._cursor + i) % len(self.names)
                   for i in range(self.batch_size)]
            self._cursor = (self._cursor + self.batch_size) % len(self.names)
        vids = np.stack([self._episode(self.names[i]) for i in idx])
        labels = np.stack([self.labels[self.names[i]] for i in idx])
        b, t = vids.shape[:2]
        n = max(t // self.batch_length, 1)
        chunks = vids[:, :n * self.batch_length].reshape(
            (b * n, self.batch_length) + vids.shape[2:])
        return {"image": torch.from_numpy(chunks).to(self.device),
                "label": torch.from_numpy(labels).to(self.device),
                "n_chunks": n}


class CaterClassifierModel(nn.Module):
    """The world model ``wm`` and the classifier ``clf`` over its
    posterior features."""

    def __init__(self, cfg, *, generator: torch.Generator):
        super().__init__()
        from ode_rl_torch.wm.classifier import FeatureClassifier
        from ode_rl_torch.wm.world_model import WorldModel

        self.n_classes = int(cfg.get("n_classes", N_CATER_CLASSES))
        self.wm = WorldModel(
            image_shape=(64, 64, int(cfg.get("in_channels", 3))),
            cnn_depth=int(cfg.get("cnn_depth", 32)),
            stoch=int(cfg.get("dyn_stoch", 32)),
            deter=int(cfg.get("dyn_deter", 200)),
            hidden=int(cfg.get("dyn_hidden", 200)),
            discrete=int(cfg.get("dyn_discrete", 0)), generator=generator)
        self.feat_dim = self.wm.feat_dim
        self.clf = FeatureClassifier(
            self.feat_dim, self.n_classes,
            hidden=int(cfg.get("classifier_units", 256)),
            generator=generator)

    def classify(self, feats: torch.Tensor, n_chunks: int) -> torch.Tensor:
        """(B n, L, F) features -> (B, n_classes): each chunk's last
        feature, the chunks of an episode in order."""
        last = feats[:, -1]
        return self.clf(last.reshape(last.shape[0] // n_chunks, n_chunks,
                                     last.shape[-1]).float())

    def logits(self, batch: Dict, generator, n_chunks: int) -> torch.Tensor:
        return self.classify(self.wm.observe_features(batch["image"],
                                                      generator), n_chunks)


@torch.no_grad()
def val_metric_sweep(model: CaterClassifierModel, val_set,
                     generator: torch.Generator, n_chunks: int) -> Dict:
    """Over the val split: ranked mAP, top-5, the mAP of random logits
    and the reference's threshold precision."""
    from ode_rl_torch.wm.classifier import (mean_average_precision,
                                            reference_map_precision,
                                            top_k_accuracy)

    logits_all, labels_all = [], []
    vs = val_set()
    for _ in range(len(vs)):
        batch = next(vs)
        logits_all.append(model.logits(batch, generator, n_chunks).cpu())
        labels_all.append(batch["label"].cpu())
    logits, labels = torch.cat(logits_all), torch.cat(labels_all)
    rand = torch.randn(logits.shape,
                       generator=torch.Generator().manual_seed(123))
    return {
        "val_mAP": float(mean_average_precision(logits, labels)),
        "val_top5": float(top_k_accuracy(logits, labels, 5)),
        "random_mAP_baseline": float(mean_average_precision(rand, labels)),
        "val_mAP_reference_metric": float(
            reference_map_precision(logits, labels)),
    }


def _generators(cfg, device: torch.device):
    """The weights' generator (on the CPU) and the sampling one."""
    seed = int(cfg.get("seed", 0))
    return (torch.Generator().manual_seed(seed),
            torch.Generator(device=device).manual_seed(seed))


def eval_cater_classifier(cfg, device: torch.device,
                          logdir: Optional[pathlib.Path] = None) -> Dict:
    from ode_rl_torch.core.checkpoint import (CheckpointManager,
                                              find_checkpoint)
    from ode_rl_torch.core.config import Config

    root_logs = pathlib.Path(logdir or cfg.get("logdir", "logs"))
    ckpt_id = cfg.get("ckpt_id") or cfg.get("id", "cater_classifier")
    ckpt_dir = find_checkpoint(root_logs, "CATER", ckpt_id)
    ckpt = CheckpointManager(ckpt_dir, tag=ckpt_id)
    saved = ckpt.load_config()
    if saved:
        merged = dict(saved)
        for k in ("batch_size", "data_dir", "seed", "eval_batches"):
            if k in cfg:
                merged[k] = cfg[k]
        cfg = Config(merged)
    root = pathlib.Path(cfg.get("data_dir", "datasets/cater_synth"))
    if not (root / "videos").exists():
        raise FileNotFoundError(
            f"no CATER corpus at {root} — run the training path first "
            "(it materializes the synthetic corpus) or point --data_dir "
            "at a reference-layout corpus")
    n_classes = int(cfg.get("n_classes", N_CATER_CLASSES))
    batch_length = int(cfg.get("batch_length", 20))
    val_set = lambda: CaterEpisodes(root, "val", cfg.batch_size,
                                    batch_length, n_classes, device=device)
    init_gen, sample_gen = _generators(cfg, device)
    model = CaterClassifierModel(cfg, generator=init_gen).to(device).eval()
    restored = ckpt.restore({"wm": model.wm.state_dict(),
                             "clf": model.clf.state_dict()})
    model.wm.load_state_dict(restored["state"]["wm"])
    model.clf.load_state_dict(restored["state"]["clf"])
    n_chunks = int(next(iter(val_set()))["n_chunks"])
    final = {**val_metric_sweep(model, val_set, sample_gen, n_chunks),
             "ckpt_step": int(restored["step"])}
    (ckpt_dir.parent / "cater_eval_test_phase.json").write_text(
        json.dumps(final, indent=2))
    print("CATER eval-only:", json.dumps(final))
    return final


def train_cater_classifier(cfg, device: torch.device,
                           logdir: Optional[pathlib.Path] = None) -> Dict:
    from ode_rl_torch.core.checkpoint import CheckpointManager
    from ode_rl_torch.core.logging import MetricLogger
    from ode_rl_torch.wm.classifier import (mean_average_precision,
                                            multilabel_bce, top_k_accuracy)
    from ode_rl_torch.wm.world_model import world_model_optimizer

    root = pathlib.Path(cfg.get("data_dir", "datasets/cater_synth"))
    if not (root / "videos").exists():
        print(f"materializing synthetic CATER corpus at {root}")
        write_synthetic_cater(root, n_train=int(cfg.get("cater_train", 120)),
                              n_val=int(cfg.get("cater_val", 40)),
                              n_frames=int(cfg.get("cater_frames", 40)))
    n_classes = int(cfg.get("n_classes", N_CATER_CLASSES))
    batch_length = int(cfg.get("batch_length", 20))
    train_set = CaterEpisodes(root, "train", cfg.batch_size, batch_length,
                              n_classes, seed=cfg.get("seed", 0),
                              device=device)
    val_set = lambda: CaterEpisodes(root, "val", cfg.batch_size,
                                    batch_length, n_classes, device=device)
    init_gen, sample_gen = _generators(cfg, device)
    model = CaterClassifierModel(cfg, generator=init_gen).to(device)
    n_chunks = int(next(train_set)["n_chunks"])
    wm_opt = world_model_optimizer(model.wm.parameters(),
                                   float(cfg.get("lr", 3e-4)))
    clf_opt = torch.optim.Adam(model.clf.parameters(),
                               lr=float(cfg.get("classifier_lr", 1e-3)),
                               betas=(0.9, 0.999), eps=1e-8)

    def train_step(batch: Dict) -> Dict:
        wm_opt.zero_grad()
        clf_opt.zero_grad(set_to_none=True)
        # One world-model forward serves both objectives.
        wm_loss, (wm_metrics, _) = model.wm.loss(
            {"image": batch["image"]}, sample_gen, return_features=True)
        logits = model.classify(wm_metrics.pop("_features"), n_chunks)
        labels = batch["label"].float()
        clf_loss = multilabel_bce(logits, labels)
        (wm_loss + clf_loss).backward()
        wm_opt.step()
        clf_opt.step()
        logits = logits.detach()
        return {"loss": wm_loss.detach() + clf_loss.detach(),
                "wm_loss": wm_loss.detach(),
                "classifier_loss": clf_loss.detach(),
                "mAP": mean_average_precision(logits, labels),
                "top5": top_k_accuracy(logits, labels, 5)}

    run_id = cfg.get("id", "cater_classifier")
    logdir = (pathlib.Path(logdir or cfg.get("logdir", "logs")) / "CATER"
              / run_id)
    logger = MetricLogger(logdir, quiet=cfg.get("quiet", False))
    ckpt = CheckpointManager(logdir / "checkpoints",
                             tag=cfg.get("ckpt_id", run_id))
    steps = ((int(cfg.get("steps_per_epoch", 0)) or len(train_set))
             * int(cfg.epochs))
    log_freq = int(cfg.get("loss_log_freq", 50))
    model.train()
    for step in range(1, steps + 1):
        metrics = train_step(next(train_set))
        if step % log_freq == 0 or step == 1:
            logger.log(step, {k: float(v) for k, v in metrics.items()})
    model.eval()
    final = {**val_metric_sweep(model, val_set, sample_gen, n_chunks),
             "steps": steps}
    logger.log(steps, final)
    ckpt.save(steps, {"wm": model.wm.state_dict(),
                      "clf": model.clf.state_dict()}, config=cfg.to_dict())
    (logdir / "cater_eval.json").write_text(json.dumps(final, indent=2))
    logger.close()
    print(f"CATER classifier: val mAP {final['val_mAP']:.3f} "
          f"(random baseline {final['random_mAP_baseline']:.3f}), "
          f"top5 {final['val_top5']:.3f}")
    return final
