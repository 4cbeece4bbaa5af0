"""Host-side data pipeline (numpy and PIL, threaded or process workers):
the port's own copy of ``arbitrarystyletransfer_tpu/data/pipeline.py``'s
datasets and loaders.

The transforms (the training augmentation stack and the eval resize),
``FlatFolderDataset``, ``_paired_make_batch``, ``_PrefetchLoader`` and
``PairedBatchLoader`` (Stage-2 training), and ``FlatFolderDatasetAE``,
``_content_make_batch`` and ``ContentBatchLoader`` (Stage-1 training and BN
recalibration), kept line for line so that a seed gives the same batches
as the JAX pipeline: NHWC float32 in [0, 1], each paired batch at one (H, W)
drawn from ``img_sizes`` x ``img_sizes``, each content batch at ``imsize``
square.  ``add_gaussian_noise`` is there too and, as in JAX, not in the
stack.  PIL is imported where it is used, so the module imports without
Pillow.
"""

from __future__ import annotations

import multiprocessing
import queue
import random
import threading
from pathlib import Path
from typing import Sequence

import numpy as np


def random_90_rot(x: np.ndarray, rng: random.Random, p: float = 0.25) -> np.ndarray:
    """Random +/-90-degree rotation (reference: data_loader.py:14-23)."""
    if rng.random() <= p:
        k = rng.choice([-1, 1])
        x = np.rot90(x, k, axes=(0, 1))
    return x


def random_flips(x: np.ndarray, rng: random.Random, p: float = 0.25) -> np.ndarray:
    """Independent horizontal/vertical flips (data_loader.py:117-118)."""
    if rng.random() <= p:
        x = x[:, ::-1]
    if rng.random() <= p:
        x = x[::-1]
    return x


def color_jitter(
    x: np.ndarray,
    rng: random.Random,
    brightness: float = 0.4,
    contrast: float = 0.10,
    saturation: float = 0.4,
    hue: float = 0.10,
    p: float = 0.25,
) -> np.ndarray:
    """ColorJitter(0.4, 0.10, 0.4, 0.10) applied with probability p
    (reference: data_loader.py:120-123).  Factor sampling matches
    torchvision: uniform in [max(0, 1-a), 1+a] for b/c/s, [-h, h] for hue,
    applied in a random order."""
    if rng.random() >= p:
        return x

    def adj_brightness(img, f):
        return np.clip(img * f, 0.0, 1.0)

    def adj_contrast(img, f):
        # torchvision: blend with the mean of the grayscale image.
        gray = img @ np.array([0.299, 0.587, 0.114], dtype=img.dtype)
        mean = gray.mean()
        return np.clip(img * f + mean * (1 - f), 0.0, 1.0)

    def adj_saturation(img, f):
        gray = img @ np.array([0.299, 0.587, 0.114], dtype=img.dtype)
        return np.clip(img * f + gray[..., None] * (1 - f), 0.0, 1.0)

    def adj_hue(img, f):
        # Shift hue via an HSV round trip (f in turns), vectorized.
        maxc = img.max(axis=-1)
        minc = img.min(axis=-1)
        v = maxc
        c = maxc - minc
        s = np.where(maxc > 0, c / np.maximum(maxc, 1e-12), 0.0)
        rc, gc, bc = img[..., 0], img[..., 1], img[..., 2]
        safe_c = np.maximum(c, 1e-12)
        h = np.where(
            maxc == rc, ((gc - bc) / safe_c) % 6.0,
            np.where(maxc == gc, (bc - rc) / safe_c + 2.0, (rc - gc) / safe_c + 4.0),
        ) / 6.0
        h = np.where(c <= 1e-12, 0.0, h)
        h = (h + f) % 1.0
        i = np.floor(h * 6.0)
        fr = h * 6.0 - i
        p_ = v * (1.0 - s)
        q_ = v * (1.0 - s * fr)
        t_ = v * (1.0 - s * (1.0 - fr))
        i = i.astype(np.int32) % 6
        r = np.choose(i, [v, q_, p_, p_, t_, v])
        g = np.choose(i, [t_, v, v, q_, p_, p_])
        b = np.choose(i, [p_, p_, t_, v, v, q_])
        return np.stack([r, g, b], axis=-1).astype(img.dtype)

    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im, f=f: adj_brightness(im, f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im, f=f: adj_contrast(im, f))
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im, f=f: adj_saturation(im, f))
    if hue > 0:
        f = rng.uniform(-hue, hue)
        ops.append(lambda im, f=f: adj_hue(im, f))
    rng.shuffle(ops)
    for op in ops:
        x = op(x)
    return x


def _resize(x: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray((np.clip(x, 0, 1) * 255).astype(np.uint8))
    img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def conditional_resize(x: np.ndarray, min_size: int) -> np.ndarray:
    """Resize shorter side up to min_size keeping aspect
    (reference: data_loader.py:26-43)."""
    h, w = x.shape[:2]
    if h < min_size or w < min_size:
        if h < w:
            new_h = min_size
            new_w = int(w / h * new_h)
        else:
            new_w = min_size
            new_h = int(h / w * new_w)
        x = _resize(x, (new_h, new_w))
    return x


def random_resized_crop(
    x: np.ndarray, rng: random.Random, size_hw: tuple[int, int]
) -> np.ndarray:
    """torchvision RandomResizedCrop defaults: scale (0.08, 1.0),
    ratio (3/4, 4/3), 10 tries then center-crop fallback."""
    h, w = x.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        log_ratio = (np.log(3 / 4), np.log(4 / 3))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch)
            j = rng.randint(0, w - cw)
            return _resize(x[i : i + ch, j : j + cw], size_hw)
    # Fallback: center crop to the valid aspect then resize.
    in_ratio = w / h
    if in_ratio < 3 / 4:
        cw, ch = w, int(round(w / (3 / 4)))
    elif in_ratio > 4 / 3:
        ch, cw = h, int(round(h * (4 / 3)))
    else:
        cw, ch = w, h
    i, j = (h - ch) // 2, (w - cw) // 2
    return _resize(x[i : i + ch, j : j + cw], size_hw)


def random_resize_or_crop(
    x: np.ndarray, rng: random.Random, size_hw: tuple[int, int], p: float = 0.90
) -> np.ndarray:
    """p: plain resize; else conditional min-size resize + random crop
    (reference: data_loader.py:45-66)."""
    if rng.random() < p:
        return _resize(x, size_hw)
    x = conditional_resize(x, min(size_hw))
    return random_resized_crop(x, rng, size_hw)


def random_blur(
    x: np.ndarray,
    rng: random.Random,
    p: float = 0.05,
    blur_sizes: Sequence[int] = (3, 5, 7, 9),
) -> np.ndarray:
    """Gaussian blur with a random kernel size (reference:
    data_loader.py:68-80; torchvision GaussianBlur picks sigma uniform in
    [0.1, 2.0] for any kernel size)."""
    if rng.random() <= p:
        k = rng.choice(list(blur_sizes))
        sigma = rng.uniform(0.1, 2.0)
        del k  # kernel size only truncates the gaussian; sigma dominates
        from PIL import Image, ImageFilter

        img = Image.fromarray((np.clip(x, 0, 1) * 255).astype(np.uint8))
        img = img.filter(ImageFilter.GaussianBlur(radius=sigma))
        x = np.asarray(img, dtype=np.float32) / 255.0
    return x


def random_grayscale(x: np.ndarray, rng: random.Random, p: float = 0.001) -> np.ndarray:
    """RandomGrayscale (reference: data_loader.py:128)."""
    if rng.random() <= p:
        gray = x @ np.array([0.299, 0.587, 0.114], dtype=x.dtype)
        x = np.repeat(gray[..., None], 3, axis=-1)
    return x


def add_gaussian_noise(x: np.ndarray, rng: random.Random, mean: float = 0.0,
                       std: float = 0.01, p: float = 0.9) -> np.ndarray:
    """Gaussian noise, clipped to [0, 1], when the draw *exceeds* ``p`` (the
    reference's rule, kept); not part of ``train_transform``'s stack."""
    if rng.random() > p:
        noise = np.random.default_rng(rng.randrange(2**31)).normal(
            mean, std, x.shape)
        x = np.clip(x + noise.astype(x.dtype), 0.0, 1.0)
    return x


def train_transform(
    x: np.ndarray, rng: random.Random, size_hw: tuple[int, int]
) -> np.ndarray:
    """The full training augmentation stack (reference: data_loader.py:110-129)."""
    x = random_90_rot(x, rng, 0.25)
    x = random_flips(x, rng, 0.25)
    x = color_jitter(x, rng, p=0.25)
    x = random_resize_or_crop(x, rng, size_hw)
    x = random_blur(x, rng, 0.05)
    x = random_grayscale(x, rng, 0.001)
    return np.ascontiguousarray(x, dtype=np.float32)


def eval_transform(x: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """Plain resize eval transform.  The reference's eval stack is broken at
    HEAD (``Resize((imsize, 256))`` with a tuple imsize,
    data_loader.py:131-135, SURVEY.md defect 4); the intended fixed-size
    resize is implemented."""
    return np.ascontiguousarray(_resize(x, size_hw), dtype=np.float32)


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


def _gather_paths(roots: Sequence[str], rng: random.Random) -> list[Path]:
    """List-of-directories glob, shuffled once (reference:
    data_loader.py:172-178)."""
    paths: list[Path] = []
    for d in roots:
        paths += [p for p in Path(d).glob("*") if p.is_file()]
    rng.shuffle(paths)
    return paths


def _load_image(path: Path) -> np.ndarray:
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # as permissive as the reference's PIL use
    img = Image.open(str(path)).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


class FlatFolderDataset:
    """Paired content+style sampler with decode-error retry
    (reference: data_loader.py:165-206)."""

    def __init__(
        self,
        content_dirs: Sequence[str],
        style_dirs: Sequence[str],
        seed: int = 0,
    ):
        # Without Pillow fail here, not in _draw's retry-on-error loop.
        import PIL.Image  # noqa: F401

        self._rng = random.Random(seed)
        self.content_paths = _gather_paths(content_dirs, self._rng)
        self.style_paths = _gather_paths(style_dirs, self._rng)
        if not self.content_paths or not self.style_paths:
            raise ValueError(
                "FlatFolderDataset: empty content or style directory list"
            )

    def _draw(self, paths: list[Path], rng: random.Random) -> np.ndarray:
        # Fresh random index per call; retry (with a new index) on any
        # decode error — the reference's only resilience feature
        # (data_loader.py:180-195).
        while True:
            path = paths[rng.randrange(len(paths))]
            try:
                return _load_image(path)
            except Exception:
                continue

    def sample_pair(self, rng: random.Random) -> tuple[np.ndarray, np.ndarray]:
        return self._draw(self.content_paths, rng), self._draw(self.style_paths, rng)

    def __len__(self):
        # Reference quirk preserved for API parity (data_loader.py:202-203).
        return len(self.content_paths) + len(self.style_paths)


class FlatFolderDatasetAE:
    """Content-only variant for AE pretraining (data_loader.py:208-242)."""

    def __init__(self, content_dirs: Sequence[str], seed: int = 0):
        import PIL.Image  # noqa: F401  (as in FlatFolderDataset)

        self._rng = random.Random(seed)
        self.content_paths = _gather_paths(content_dirs, self._rng)
        if not self.content_paths:
            raise ValueError("FlatFolderDatasetAE: empty directory list")

    def _draw(self, rng: random.Random) -> np.ndarray:
        while True:
            path = self.content_paths[rng.randrange(len(self.content_paths))]
            try:
                return _load_image(path)
            except Exception:
                continue

    def sample(self, rng: random.Random) -> np.ndarray:
        return self._draw(self._rng if rng is None else rng)

    def __len__(self):
        return len(self.content_paths)


def _paired_make_batch(dataset, batch_size, img_sizes, augment, rng):
    """One (content, style) batch at a per-batch random bucketed size
    (reference data_loader.py:83-105; conf.py:4).  Module-level so process
    workers can receive it by reference through spawn pickling."""
    h = rng.choice(img_sizes)
    w = rng.choice(img_sizes)
    contents, styles = [], []
    for _ in range(batch_size):
        c, s = dataset.sample_pair(rng)
        if augment:
            contents.append(train_transform(c, rng, (h, w)))
            styles.append(train_transform(s, rng, (h, w)))
        else:
            contents.append(eval_transform(c, (h, w)))
            styles.append(eval_transform(s, (h, w)))
    return np.stack(contents), np.stack(styles)


def _content_make_batch(dataset, batch_size, imsize, augment, rng):
    """One content-only batch (AE pretraining; reference
    train_autoencoder.py:186-195 uses the non-augmenting transform)."""
    imgs = []
    for _ in range(batch_size):
        x = dataset.sample(rng)
        if augment:
            imgs.append(train_transform(x, rng, (imsize, imsize)))
        else:
            imgs.append(eval_transform(x, (imsize, imsize)))
    return np.stack(imgs)


def _process_worker(batch_fn, fn_args, seed, out_queue, stop):
    """Process-worker loop: produce batches until told to stop.  Runs in a
    forkserver child that imported only this module's dependency set (no
    CUDA context crosses the fork)."""
    rng = random.Random(seed)
    while not stop.is_set():
        batch = batch_fn(*fn_args, rng)
        while not stop.is_set():
            try:
                out_queue.put(batch, timeout=0.5)
                break
            except queue.Full:
                continue


class _PrefetchLoader:
    """Bounded-queue prefetcher producing NHWC float32 batches.

    ``worker_mode="thread"``: daemon threads sharing this process (cheap
    startup; throughput capped by the GIL — fine for tests/small runs).
    ``worker_mode="process"``: spawn-context worker processes (the
    training default; scales with cores).  ``batch_fn`` must be a
    module-level function and ``fn_args`` picklable in process mode.
    """

    def __init__(
        self,
        batch_fn,
        fn_args,
        num_workers: int,
        prefetch: int,
        seed: int,
        worker_mode: str = "thread",
    ):
        self._procs = []
        self._threads = []
        if worker_mode == "process":
            # forkserver + preload of THIS module: workers fork from a
            # server process that imported only the pipeline's dependency
            # set (no CUDA state is duplicated), and (unlike spawn) the
            # CLI's __main__ is not re-imported per worker.
            ctx = multiprocessing.get_context("forkserver")
            ctx.set_forkserver_preload([__name__])
            self._queue = ctx.Queue(maxsize=prefetch)
            self._stop = ctx.Event()
            for w in range(max(1, num_workers)):
                p = ctx.Process(
                    target=_process_worker,
                    args=(batch_fn, fn_args, seed + 7919 * w, self._queue,
                          self._stop),
                    daemon=True,
                )
                p.start()
                self._procs.append(p)
        elif worker_mode == "thread":
            self._queue = queue.Queue(maxsize=prefetch)
            self._stop = threading.Event()

            def worker(wseed):
                rng = random.Random(wseed)
                while not self._stop.is_set():
                    batch = batch_fn(*fn_args, rng)
                    while not self._stop.is_set():
                        try:
                            self._queue.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue

            for w in range(max(1, num_workers)):
                t = threading.Thread(
                    target=worker, args=(seed + 7919 * w,), daemon=True
                )
                t.start()
                self._threads.append(t)
        else:
            raise ValueError(f"worker_mode must be thread|process: {worker_mode}")

    def __iter__(self):
        return self

    def __next__(self):
        return self._queue.get()

    def close(self):
        self._stop.set()
        # Drain so workers blocked on put() can observe the stop flag.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for p in self._procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
        # Wait for the thread workers to finish their batch: a worker still
        # drawing once its files are gone (a temporary folder the caller
        # removes after close) would retry the unreadable paths forever.
        for t in self._threads:
            t.join(timeout=30.0)


class PairedBatchLoader(_PrefetchLoader):
    """Infinite (content, style) batches at per-batch random bucketed sizes.

    Every batch draws one (H, W) from ``img_sizes`` x ``img_sizes`` — the
    bucketed-static-shape equivalent of the reference's multi-resolution
    training (data_loader.py:83-105; conf.py:4).
    """

    def __init__(
        self,
        dataset: FlatFolderDataset,
        batch_size: int,
        img_sizes: Sequence[int] = (96, 128, 160),
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        augment: bool = True,
        worker_mode: str = "thread",
    ):
        self.batch_size = batch_size
        self.img_sizes = tuple(img_sizes)
        super().__init__(
            _paired_make_batch,
            (dataset, batch_size, self.img_sizes, augment),
            num_workers, prefetch, seed, worker_mode,
        )


class ContentBatchLoader(_PrefetchLoader):
    """Infinite content-only batches at a fixed size (AE pretraining, BN
    recalibration)."""

    def __init__(
        self,
        dataset: FlatFolderDatasetAE,
        batch_size: int,
        imsize: int = 256,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        augment: bool = False,
        worker_mode: str = "thread",
    ):
        self.batch_size = batch_size
        super().__init__(
            _content_make_batch,
            (dataset, batch_size, imsize, augment),
            num_workers, prefetch, seed, worker_mode,
        )
