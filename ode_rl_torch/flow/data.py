"""Flow datasets and ``.flo`` I/O.

Counterpart of ``ode_rl_tpu/flow/data.py``:

* Middlebury ``.flo`` read and write (magic 202021.25, int32 width and
  height, interleaved float32 u, v);
* the FlyingChairs corpus layout: sorted images taken as (2i, 2i+1) pairs
  with the sorted ``*.flo`` targets, a deterministic train/val split by
  sample index, frames centre-cropped to a multiple of 64, random train
  batches from ``np.random.RandomState(seed).randint`` and a cursor over
  the val split, so one directory and seed give JAX's batches bit for bit;
* ``write_synthetic_chairs``, a corpus from the port's synthetic
  generator, written as binary PPM pairs and ``.flo`` files that JAX's
  reader accepts;
* ``validate_epe``, the mean end-point error over a corpus.

Images are decoded in numpy: 8-bit binary PPM (P6, P5; header comments
allowed) and PNG (8-bit gray, gray + alpha, RGB or RGBA; not interlaced,
no palette). JAX decodes with ``imageio``, which the card host lacks; the
port reads no other format and names the ones it reads when asked to.
"""

from __future__ import annotations

import pathlib
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

_FLO_MAGIC = 202021.25
IMAGE_EXTS = (".ppm", ".png", ".jpg", ".jpeg")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour types read: samples a pixel.
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_flo(path) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        if data.size != 2 * w * h:
            raise ValueError(f"{path}: truncated .flo ({data.size} floats)")
    return data.reshape(h, w, 2)


def write_flo(path, flow: np.ndarray) -> None:
    """(H, W, 2) float32 -> Middlebury .flo."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"a flow is (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.tofile(f)


def _ppm_header(data: bytes, path) -> Tuple[bytes, list, int]:
    """(magic, [width, height, maxval], offset of the raster)."""
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated PPM header")
        fields.append(data[start:pos])
    # One whitespace byte ends the header.
    return fields[0], [int(f) for f in fields[1:]], pos + 1


def read_ppm(path) -> np.ndarray:
    """8-bit binary PPM (P6) or PGM (P5) -> (H, W, C) uint8."""
    data = pathlib.Path(path).read_bytes()
    magic, (w, h, maxval), pos = _ppm_header(data, path)
    if magic not in (b"P6", b"P5") or maxval > 255:
        raise ValueError(f"{path}: {magic!r} with maxval {maxval} is not an "
                         "8-bit binary PPM/PGM")
    c = 3 if magic == b"P6" else 1
    raster = np.frombuffer(data, np.uint8, count=h * w * c, offset=pos)
    return raster.reshape(h, w, c)


def write_ppm(path, image: np.ndarray) -> None:
    """(H, W, 3) uint8 -> binary PPM (P6)."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    if c != 3:
        raise ValueError(f"a PPM holds RGB, got {c} channels")
    pathlib.Path(path).write_bytes(f"P6\n{w} {h}\n255\n".encode()
                                   + image.tobytes())


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, w: int, bpp: int, path) -> np.ndarray:
    """The PNG scanlines (a filter byte, then w * bpp bytes each) ->
    (h, w * bpp) uint8, with filters 0-4 undone."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"{path}: {rows.size} bytes of image data for "
                         f"{h} rows of {stride + 1}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prior) & 0xFF
        elif kind == 1:
            # Sub: a running sum of each sample with the one bpp before.
            cur = (np.cumsum(line.reshape(w, bpp), axis=0) & 0xFF).reshape(-1)
        elif kind in (3, 4):
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(w):
                s = slice(x * bpp, (x + 1) * bpp)
                up = prior[s]
                pred = ((left + up) >> 1 if kind == 3
                        else _paeth(left, up, up_left))
                cur[s] = (line[s] + pred) & 0xFF
                left, up_left = cur[s], up
        else:
            raise ValueError(f"{path}: PNG filter type {kind}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def read_png(path) -> np.ndarray:
    """8-bit PNG (gray, gray + alpha, RGB, RGBA; not interlaced) ->
    (H, W, C) uint8."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}; only 8-bit gray, gray + alpha, RGB and "
            "RGBA without interlacing are read")
    c = _PNG_CHANNELS[colour]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w, c, path)
    return rows.reshape(h, w, c)


def _read_image(path) -> np.ndarray:
    """An image -> (H, W, 3) float32 in [0, 1] (gray repeated, alpha
    dropped), as JAX's ``_read_image``."""
    suffix = pathlib.Path(path).suffix.lower()
    if suffix == ".ppm":
        img = read_ppm(path)
    elif suffix == ".png":
        img = read_png(path)
    else:
        raise ValueError(f"{path}: {suffix} images are not read; the port "
                         "reads 8-bit binary PPM (P6, P5) and PNG")
    if img.shape[-1] < 3:
        img = img[..., :1].repeat(3, axis=-1)
    return img[..., :3].astype(np.float32) / 255.0


def _center_crop64(img: np.ndarray) -> np.ndarray:
    """Crop to the largest multiple-of-64 size (pyramid alignment)."""
    h, w = img.shape[:2]
    th, tw = (h // 64) * 64, (w // 64) * 64
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return img[y0:y0 + th, x0:x0 + tw]


class FlyingChairsCorpus:
    """FlyingChairs-layout corpus: a flat directory of image pairs and
    ``.flo`` files. Each ``next`` gives numpy (img1, img2, flow) of shapes
    (B, H, W, 3), (B, H, W, 3), (B, H, W, 2)."""

    def __init__(self, root, batch_size: int = 8, is_train: bool = True,
                 train_split: float = 0.9, seed: int = 0,
                 crop_multiple64: bool = True):
        root = pathlib.Path(root)
        images = sorted(p for p in root.iterdir()
                        if p.suffix.lower() in IMAGE_EXTS)
        self.flows = sorted(root.glob("*.flo"))
        if not self.flows:
            raise FileNotFoundError(f"no .flo files under {root}")
        if len(images) != 2 * len(self.flows):
            raise ValueError(
                f"{root}: {len(images)} images for {len(self.flows)} flows "
                "(expected 2 per flow, FlyingChairs layout)")
        self.pairs = [(images[2 * i], images[2 * i + 1])
                      for i in range(len(self.flows))]
        n_train = int(len(self.pairs) * train_split)
        sel = slice(0, n_train) if is_train else slice(n_train, None)
        self.pairs, self.flows = self.pairs[sel], self.flows[sel]
        if not self.pairs:
            raise ValueError(f"{root}: empty {'train' if is_train else 'val'}"
                             " split")
        self.batch_size = batch_size
        self.train = is_train
        self.crop = crop_multiple64
        self._rng = np.random.RandomState(seed)
        self._cursor = 0

    def __len__(self) -> int:
        return max(len(self.pairs) // self.batch_size, 1)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        return self

    def _load(self, i: int):
        p1, p2 = self.pairs[i]
        img1, img2 = _read_image(p1), _read_image(p2)
        flow = read_flo(self.flows[i])
        if self.crop:
            img1, img2, flow = map(_center_crop64, (img1, img2, flow))
        return img1, img2, flow

    def __next__(self):
        if self.train:
            idx = self._rng.randint(0, len(self.pairs), self.batch_size)
        else:
            idx = [(self._cursor + i) % len(self.pairs)
                   for i in range(self.batch_size)]
            self._cursor = (self._cursor + self.batch_size) % len(self.pairs)
        i1, i2, fl = zip(*(self._load(i) for i in idx))
        return np.stack(i1), np.stack(i2), np.stack(fl)


def _to_uint8(x: torch.Tensor) -> np.ndarray:
    """[0, 1] -> uint8 by truncation, as JAX's writer casts."""
    return (x.detach().cpu().numpy() * 255).clip(0, 255).astype(np.uint8)


def write_synthetic_chairs(out, n_pairs: int = 32, size: int = 64,
                           seed: int = 0, style: str = "digits",
                           device: torch.device = torch.device("cpu")
                           ) -> pathlib.Path:
    """A FlyingChairs-layout corpus of ``n_pairs`` (``{i:05d}_img1.ppm``,
    ``_img2.ppm``, ``_flow.flo``) from the port's synthetic generator
    (flow/train.py), batches of 8 drawn from a generator seeded with
    ``seed`` on ``device``. The generator makes 64x64 pairs: JAX's writer
    takes ``size`` and ignores it in 'digits' style, and in 'smooth'
    style would warp a 64x64 image by a size x size field, so any other
    ``size`` raises here."""
    from ode_rl_torch.data.sprites import get_sprite_bank
    from ode_rl_torch.flow.train import synthetic_flow_batch

    if size != 64:
        raise ValueError(f"the synthetic generator makes 64x64 pairs, not "
                         f"{size}x{size}")
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    bank = torch.from_numpy(get_sprite_bank()).float().to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    done = 0
    while done < n_pairs:
        b = min(8, n_pairs - done)
        img1, img2, flow = synthetic_flow_batch(generator, bank, batch=8,
                                                style=style)
        img1, img2 = _to_uint8(img1), _to_uint8(img2)
        flow = flow.detach().cpu().numpy()
        for i in range(b):
            stem = f"{done + i:05d}"
            write_ppm(out / f"{stem}_img1.ppm", img1[i])
            write_ppm(out / f"{stem}_img2.ppm", img2[i])
            write_flo(out / f"{stem}_flow.flo", flow[i])
        done += b
    return out


def validate_epe(model: torch.nn.Module, corpus, pair_input: bool = True,
                 single_scale: bool = False,
                 max_batches: Optional[int] = None) -> float:
    """Mean end-point error over the corpus's batches (one pass, at most
    ``max_batches``), without autograd, on the model's device.
    ``pair_input=False`` for the two-image nets (FlowNetC, FlowNet2).
    Pyramid nets are scored on their finest flow, which must be at a
    quarter of the resolution: resized bilinearly to full resolution and
    scaled by 4. ``single_scale`` (FlowNet2) scores its one flow."""
    from ode_rl_torch.flow.losses import epe
    from ode_rl_torch.ops.resize import resize_bilinear

    device = next(model.parameters()).device
    total, n = 0.0, 0
    with torch.no_grad():
        for b, batch in enumerate(corpus):
            if max_batches is not None and b >= max_batches:
                break
            img1, img2, flow = (torch.from_numpy(np.asarray(a)).to(device)
                                for a in batch)
            inputs = ((torch.cat([img1, img2], dim=-1),) if pair_input
                      else (img1, img2))
            flows = model(*inputs)
            if single_scale:
                err = epe(flows, flow)
            else:
                stride = flow.shape[1] // flows[0].shape[1]
                if stride != 4:
                    raise AssertionError(
                        f"validate_epe assumes a stride-4 finest level (x4.0 "
                        f"magnitude); this net's finest output is stride "
                        f"{stride}")
                full = resize_bilinear(flows[0], flow.shape[1],
                                       flow.shape[2]) * 4.0
                err = epe(full, flow)
            total += float(err)
            n += 1
            if n >= len(corpus):
                break
    return total / max(n, 1)
