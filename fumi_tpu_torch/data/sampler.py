"""The device episode sampler.

The counterpart of ``fumi_tpu/data/sampler.py``'s ``SamplerTables``,
``pixels_to_float``, ``sample_episode`` and ``DeviceEpisodeSampler``. All
tables live on the device; an episode is drawn there with no host
transfer: top-N of uniform noise picks N distinct classes per task, and a
per-class argsort of masked uniform noise picks K+Q distinct images per
class (sampling without replacement as one vectorised op), then the rows
are gathered. With ``use_pallas_gather`` (``--tpu_pallas_gather``) the
episode's image rows, support and query, are gathered and widened in one
launch of ``ops/kernels.py:gather_episode_rows``, the hand-written CUDA
kernel; otherwise they are plain indexing, as the JAX package uses XLA's
gather when the flag is off.

:func:`sample_episode` draws its noise from a ``torch.Generator`` on the
table's device, then calls :func:`episode_from_noise`, a pure function of
the noise, so the tests can feed it the JAX package's own noise. With
``augment_scale > 0`` (``--augment``) the support embeddings are jittered
from a one-element seed the generator draws on the device, so no value
crosses to the host: with the kernel gather as the epilogue of the
support rows in that one launch; without it by the library gather
followed by ``ops/kernels.py:augment_embeddings``, the standalone CUDA
jitter. The two give bitwise the same episode.
``episode_from_noise(aug_noise=...)`` takes the jitter as noise instead,
the form the tests feed JAX's noise through.

A raw-image table (R, H, W, C) (fp32, bf16 or uint8) is gathered through
its contiguous (R, H·W·C) view, by the same one launch of
``gather_episode_rows`` or by plain indexing, and the episode's images
come out (B, N·K, H, W, C) fp32 (uint8 pixels in [0, 1]). ``--augment``
on raw images is the random horizontal flip and the edge-padded random
crop (pad 4) of :func:`augment_raw_images`, on the support images only;
its noise (flip bits, crop offsets) comes from the generator, or through
``episode_from_noise(raw_aug=...)`` from the tests. :func:`table_storage`
stores a floating table in bf16 under ``--tpu_compute_dtype bfloat16``.

The host samplers (``--tpu_host_sampler``) are the JAX package's:
:class:`HostEpisodeSampler` (numpy or native indices, numpy assembly, a
synchronous copy to the device), :class:`PrefetchingSampler` (a thread)
and :class:`MultiprocessSampler` (loader processes).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fumi_tpu_torch.core.episode import Episode, EpisodeSpec, \
    class_major_labels
from fumi_tpu_torch.core.runtime import DeviceLike, resolve_device
from fumi_tpu_torch.data.class_set import ClassSet
from fumi_tpu_torch.ops import kernels
# the widening the episode's gather kernel applies, kept beside it
from fumi_tpu_torch.ops.kernels import pixels_to_float


class SamplerTables(NamedTuple):
    """Device-resident episodic tables."""
    image_table: torch.Tensor  # (num_images, D) or (num_images, H, W, C)
    image_ids: torch.Tensor  # (num_images,) int32
    class_rows: torch.Tensor  # (C, max_count) int32
    class_counts: torch.Tensor  # (C,) int32
    text_features: torch.Tensor  # (C, E) fp32, or (C, T) int32 tokens


def table_storage(table: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """The stored dtype of the episodic table under
    ``--tpu_compute_dtype``: ``bfloat16`` halves a floating table's memory
    and gather bytes (episodes are widened back to fp32 at gather time);
    integer tables (uint8 raw pixels) are left as they are."""
    if compute_dtype == "bfloat16" and table.dtype.is_floating_point:
        return table.to(torch.bfloat16)
    return table


RawAug = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def raw_augment_noise(m: int, gen: torch.Generator, pad: int = 4) -> RawAug:
    """``(flip, oy, ox)`` for ``m`` images from ``gen`` on its device: flip
    bits with probability 1/2 and crop offsets uniform in [0, 2·pad]."""
    dev = gen.device
    flip = torch.rand((m,), generator=gen, device=dev) < 0.5
    oy = torch.randint(0, 2 * pad + 1, (m,), generator=gen, device=dev)
    ox = torch.randint(0, 2 * pad + 1, (m,), generator=gen, device=dev)
    return flip, oy, ox


def augment_raw_images(images: torch.Tensor, flip: torch.Tensor,
                       oy: torch.Tensor, ox: torch.Tensor,
                       pad: int = 4) -> torch.Tensor:
    """Random horizontal flip, then a random crop of the edge-padded image,
    per image of (M, H, W, C): image m is mirrored where ``flip[m]``, padded
    by ``pad`` on each side with its edge values (zeros would bias the
    backbones' batch statistics) and cropped back to H×W at offset
    (``oy[m]``, ``ox[m]``) in [0, 2·pad]. The crop is one gather with
    clamped indices, which is the edge padding."""
    M, H, W, _ = images.shape
    images = torch.where(flip.reshape(M, 1, 1, 1), images.flip(2), images)
    ry = (oy.reshape(M, 1) - pad + torch.arange(H, device=images.device)
          ).clamp(0, H - 1)
    rx = (ox.reshape(M, 1) - pad + torch.arange(W, device=images.device)
          ).clamp(0, W - 1)
    m = torch.arange(M, device=images.device).reshape(M, 1, 1)
    return images[m, ry.reshape(M, H, 1), rx.reshape(M, 1, W)]


def episode_from_noise(tables: SamplerTables, spec: EpisodeSpec,
                       cls_noise: torch.Tensor, img_noise: torch.Tensor,
                       aug_noise: Optional[torch.Tensor] = None,
                       use_pallas_gather: bool = False,
                       aug_seed: Optional[torch.Tensor] = None,
                       augment_scale: float = 0.0,
                       raw_aug: Optional[RawAug] = None) -> Episode:
    """One meta-batch from the tables and the noise that picks it.

    ``cls_noise`` (B, C) and ``img_noise`` (B, N, max_count) are uniform in
    [0, 1). The SUPPORT embeddings are jittered (train-time augmentation;
    queries stay clean) either by ``aug_noise`` (B, N*K, D), uniform in
    [-s, s), as ``x * (1 + aug_noise)``, or by the Philox jitter keyed by
    ``aug_seed`` (a one-element int64 tensor) at ``augment_scale``; or not
    at all when both are None. With ``use_pallas_gather`` one
    ``gather_episode_rows`` launch gathers and widens the support and
    query rows, the seeded jitter as the epilogue of the support rows;
    without it the library gather is followed by the standalone
    ``augment_embeddings`` kernel. The flag picks the route, and both
    give bitwise the same episode. A raw-image table takes ``raw_aug``
    instead, the (flip, oy, ox) noise of :func:`augment_raw_images` for
    the B·N·K support images."""
    if aug_noise is not None and aug_seed is not None:
        raise ValueError("episode_from_noise: aug_noise or aug_seed, not both")
    raw = tables.image_table.dim() == 4
    if raw and (aug_noise is not None or aug_seed is not None):
        raise ValueError("raw-image tables augment by flip and crop "
                         "(raw_aug), not the embedding jitter")
    if raw_aug is not None and not raw:
        raise ValueError("raw_aug needs a raw-image (R, H, W, C) table")
    B, N, K, Q = (spec.batch_size, spec.num_ways, spec.num_shots,
                  spec.num_query)
    max_count = tables.class_rows.shape[1]
    dev = cls_noise.device

    # N distinct classes per task: top-N of uniform noise over C
    _, class_idx = torch.topk(cls_noise, N, dim=-1, sorted=True)  # (B, N)
    counts = tables.class_counts[class_idx]  # (B, N)
    # K+Q distinct images per class: argsort of masked noise puts the
    # class's `count` valid slots first, shuffled; indexed modulo `count`
    # (distinct while count >= K+Q, a with-replacement wrap otherwise)
    slot = torch.arange(max_count, device=dev)
    img_noise = torch.where(slot < counts.unsqueeze(-1), img_noise, -1.0)
    order = torch.argsort(-img_noise, dim=-1, stable=True)
    j = torch.arange(K + Q, device=dev)
    take = j % torch.clamp(counts.unsqueeze(-1), min=1)  # (B, N, K+Q)
    sel = torch.gather(order, -1, take.long())
    rows = torch.gather(tables.class_rows[class_idx], -1, sel)  # int32
    s_rows = rows[..., :K].reshape(B, N * K)
    q_rows = rows[..., K:].reshape(B, N * Q)

    table = tables.image_table
    if raw:
        # the contiguous (R, H·W·C) view of the NHWC table
        table = table.reshape(table.shape[0], -1)
    seeded = aug_seed is not None and augment_scale > 0.0
    if use_pallas_gather:
        support_im, query_im = kernels.gather_episode_rows(
            table, rows, K, aug_seed if seeded else None,
            augment_scale if seeded else 0.0)
    else:
        support_im = pixels_to_float(table[s_rows.long()])
        query_im = pixels_to_float(table[q_rows.long()])
        if seeded:
            flat = kernels.augment_embeddings(
                support_im.reshape(B * N * K, -1), aug_seed, augment_scale)
            support_im = flat.reshape(support_im.shape)
    if aug_noise is not None:
        support_im = support_im * (1.0 + aug_noise)
    if raw:
        pixel = tuple(tables.image_table.shape[1:])
        support_im = support_im.reshape((B, N * K) + pixel)
        query_im = query_im.reshape((B, N * Q) + pixel)
        if raw_aug is not None:
            support_im = augment_raw_images(
                support_im.reshape((B * N * K,) + pixel),
                *raw_aug).reshape(support_im.shape)

    # per-class text repeated per shot, class-major like the targets
    text_cls = tables.text_features[class_idx]  # (B, N, E|T)
    return Episode(
        support_im=support_im,
        support_text=text_cls.repeat_interleave(K, dim=1),
        support_text_mask=None,
        support_ids=tables.image_ids[s_rows.long()],
        support_y=class_major_labels(B, N, K, dev),
        query_im=query_im,
        query_ids=tables.image_ids[q_rows.long()],
        query_y=class_major_labels(B, N, Q, dev),
    )


def sample_episode(tables: SamplerTables, spec: EpisodeSpec,
                   gen: torch.Generator, use_pallas_gather: bool = False,
                   augment_scale: float = 0.0) -> Episode:
    """Draw one meta-batch on the tables' device: the noise comes from
    ``gen`` (a generator on that device), in the JAX package's order
    (classes, images, then the augmentation's seed)."""
    B, N = spec.batch_size, spec.num_ways
    C, max_count = tables.class_rows.shape
    dev = tables.class_rows.device
    cls_noise = torch.rand((B, C), generator=gen, device=dev)
    img_noise = torch.rand((B, N, max_count), generator=gen, device=dev)
    aug_seed = raw_aug = None
    if augment_scale > 0.0 and tables.image_table.dim() == 4:
        raw_aug = raw_augment_noise(B * N * spec.num_shots, gen)
    elif augment_scale > 0.0:
        aug_seed = torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 dtype=torch.int64, device=dev)
    return episode_from_noise(tables, spec, cls_noise, img_noise,
                              use_pallas_gather=use_pallas_gather,
                              aug_seed=aug_seed, augment_scale=augment_scale,
                              raw_aug=raw_aug)


class DeviceEpisodeSampler:
    """On-device episodic sampler over one split.

    Args:
      image_table: (num_images, D) image embeddings, or (num_images, H, W,
                   C) raw images (numpy or tensor; fp32, bf16 or uint8).
      image_ids:   (num_images,) row -> raw image id.
      class_set:   the split's ClassSet.
      spec:        episode geometry.
      use_pallas_gather: gather image rows with the CUDA kernel
                   (``--tpu_pallas_gather``).
      augment_scale: support-embedding jitter scale (0 = off); on a raw
                   table any scale > 0 turns on the flip and crop.
      allow_replacement: opt IN to with-replacement sampling for classes
                   with fewer than K+Q images. Default False: construction
                   fails fast via ``class_set.validate_episode``.
      device:      where the tables live; default the current CUDA device,
                   ``"cpu"`` for the CPU.
    """

    def __init__(self, image_table, image_ids, class_set: ClassSet,
                 spec: EpisodeSpec, use_pallas_gather: bool = False,
                 augment_scale: float = 0.0, allow_replacement: bool = False,
                 device: DeviceLike = None):
        if not allow_replacement:
            class_set.validate_episode(spec.num_shots, spec.num_query)
        elif np.any(np.asarray(class_set.class_counts) < 1):
            # even with replacement there is nothing to draw from an empty
            # class: the wrap would silently emit padding rows
            raise ValueError("split contains classes with zero images")
        self.spec = spec
        self.device = resolve_device(device)

        def put(a, dtype=None):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                   else a, dtype=dtype).to(self.device)
        self.tables = SamplerTables(
            image_table=put(image_table).contiguous(),
            image_ids=put(image_ids, torch.int32),
            class_rows=put(class_set.class_image_rows, torch.int32),
            class_counts=put(class_set.class_counts, torch.int32),
            text_features=put(class_set.text_features),
        )
        if class_set.num_classes < spec.num_ways:
            raise ValueError(
                f"split has {class_set.num_classes} classes but episodes "
                f"need num_ways={spec.num_ways}")
        self.num_classes = class_set.num_classes
        self.use_pallas_gather = use_pallas_gather
        self.augment_scale = augment_scale

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the tables' device, seeded."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def sample(self, gen: torch.Generator,
               tables: Optional[SamplerTables] = None) -> Episode:
        return sample_episode(tables if tables is not None else self.tables,
                              self.spec, gen,
                              use_pallas_gather=self.use_pallas_gather,
                              augment_scale=self.augment_scale)


# ---------------------------------------------------------------------------
# Host samplers (--tpu_host_sampler)
# ---------------------------------------------------------------------------

def _host_table(image_table) -> Tuple[np.ndarray, bool]:
    """A numpy table the loader workers can gather from, and whether its
    rows are bf16 (kept as their 16-bit patterns, int16: numpy has no
    bf16; a torch bf16 tensor or an ml_dtypes bf16 array)."""
    if torch.is_tensor(image_table):
        t = image_table.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), True
        return t.numpy(), False
    arr = np.asarray(image_table)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.int16), True
    return arr, False


class HostEpisodeSampler:
    """The reference's sampling policy on the host.

    The counterpart of the JAX package's ``HostEpisodeSampler``, with the
    same streams: torchmeta's CombinationMetaDataset + ClassSplitter
    (shuffle=True) policy, a uniform N-class combination and a per-class
    permutation whose first K are the support and next Q the query,
    deterministic under ``seed``. The indices come from the native sampler
    (``fumi_tpu_torch/native``, xoshiro256** streams addressed by
    ``(seed, episode counter)``) or, with ``backend="numpy"`` or where it
    cannot be built, from a ``numpy.random.RandomState(seed)``; the two
    backends draw the same policy but different streams. Both give
    bitwise the JAX package's indices and rows for the same seed.

    Assembly (:meth:`_assemble_numpy`) is numpy only, so loader processes
    can run it; :meth:`_finish` copies the parts to ``device``
    synchronously (the numpy buffers are the episode's own, never reused),
    widens them as the device path does (uint8 pixels to [0, 1], bf16 to
    fp32), and with ``augment_scale > 0`` augments the support set: raw
    images by the flip and crop of :func:`augment_raw_images`, embeddings
    by :func:`~fumi_tpu_torch.ops.kernels.augment_embeddings` (the CUDA
    kernel on the card, its plain version on the CPU). The augmentation's
    seed is drawn as the JAX package draws its key,
    ``rng.randint(0, 2**31)``, so the numpy stream, and with it every later
    episode of the numpy backend, stays the JAX package's.

    ``allow_replacement=True`` lets classes thinner than K+Q wrap (numpy
    backend only), as the device sampler's permissive mode does.
    """

    def __init__(self, image_table, image_ids, class_set: ClassSet,
                 spec: EpisodeSpec, seed: int = 0, backend: str = "auto",
                 allow_replacement: bool = False, augment_scale: float = 0.0,
                 device: DeviceLike = None):
        if not allow_replacement:
            class_set.validate_episode(spec.num_shots, spec.num_query)
        elif np.any(np.asarray(class_set.class_counts) < 1):
            raise ValueError("split contains classes with zero images")
        need = spec.num_shots + spec.num_query
        self._wraps = bool(np.any(class_set.class_counts < need))
        self.allow_replacement = allow_replacement
        self._backend_arg = backend
        self.spec = spec
        self.image_table, self._bf16 = _host_table(image_table)
        self.image_ids = np.asarray(image_ids, dtype=np.int32)
        self.class_set = class_set
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.augment_scale = augment_scale
        self.device = resolve_device(device)
        self._counter = 0
        self._native = None
        self._load_native()

    def _load_native(self) -> None:
        if self._backend_arg in ("auto", "native") and not self._wraps:
            # the C++ sampler assumes count >= K+Q; wrap mode stays numpy
            from fumi_tpu_torch import native
            self._native = native.load()
            if self._backend_arg == "native" and self._native is None:
                raise RuntimeError("native sampler unavailable (no g++?)")
        elif self._backend_arg == "native" and self._wraps:
            raise RuntimeError(
                "--tpu_sampler_backend native cannot serve classes thinner "
                "than K+Q (the with-replacement wrap is numpy-only)")

    def __getstate__(self):
        """Picklable for ``spawn`` loader workers: the ctypes handle is
        dropped and loaded again on the other side (the library is built
        already, so that is a dlopen)."""
        state = self.__dict__.copy()
        state["_native"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._load_native()

    @property
    def backend_name(self) -> str:
        """The index backend in use: ``native`` or ``numpy`` (different
        streams for the same seed)."""
        return "numpy" if self._native is None else "native"

    def _draw_indices(self, B, N, K, Q):
        """``(class_idx (B, N), sel (B, N, K+Q))`` from the backend."""
        cs = self.class_set
        if self._native is not None:
            from fumi_tpu_torch import native
            class_idx, sel = native.sample_episodes_native(
                self._native, self.seed, self._counter, cs.class_counts,
                B, N, K + Q)
            self._counter += 1
            return class_idx, sel
        class_idx = np.empty((B, N), dtype=np.int64)
        sel = np.empty((B, N, K + Q), dtype=np.int64)
        for b in range(B):
            class_idx[b] = self.rng.choice(cs.num_classes, size=N,
                                           replace=False)
            for i, c in enumerate(class_idx[b]):
                cnt = int(cs.class_counts[c])
                # the modulo wrap is with-replacement for thin classes and
                # a no-op when cnt >= K+Q
                sel[b, i] = self.rng.permutation(cnt)[
                    np.arange(K + Q) % max(cnt, 1)]
        return class_idx, sel

    def _indices_at(self, counter: int):
        """The native draw of episode ``counter``, stateless: any loader
        worker can compute any episode."""
        if self._native is None:
            raise RuntimeError("counter-addressed sampling needs the "
                               "native backend")
        from fumi_tpu_torch import native
        spec = self.spec
        return native.sample_episodes_native(
            self._native, self.seed, counter, self.class_set.class_counts,
            spec.batch_size, spec.num_ways,
            spec.num_shots + spec.num_query)

    def _assemble_numpy(self, class_idx, sel) -> dict:
        """The episode's parts as numpy arrays from drawn indices; no
        tensor and no device, so loader worker processes run it."""
        spec = self.spec
        cs = self.class_set
        B, N, K, Q = (spec.batch_size, spec.num_ways, spec.num_shots,
                      spec.num_query)
        rows = np.take_along_axis(
            cs.class_image_rows[class_idx], sel, axis=-1)  # (B, N, K+Q)
        s_rows = rows[..., :K].reshape(B, N * K)
        q_rows = rows[..., K:].reshape(B, N * Q)
        text_cls = cs.text_features[class_idx]  # (B, N, E|T)
        s_y = np.tile(np.repeat(np.arange(N, dtype=np.int32), K)[None],
                      (B, 1))
        q_y = np.tile(np.repeat(np.arange(N, dtype=np.int32), Q)[None],
                      (B, 1))
        return dict(support_im=self.image_table[s_rows],
                    support_text=np.repeat(text_cls, K, axis=1),
                    support_ids=self.image_ids[s_rows], support_y=s_y,
                    query_im=self.image_table[q_rows],
                    query_ids=self.image_ids[q_rows], query_y=q_y)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _images(self, a: np.ndarray) -> torch.Tensor:
        t = self._put(a)
        return pixels_to_float(t.view(torch.bfloat16) if self._bf16 else t)

    def _finish(self, parts: dict) -> Episode:
        """The assembled parts on the device, widened and (train support
        set) augmented, with the seed from this sampler's numpy stream."""
        spec = self.spec
        B, N, K = spec.batch_size, spec.num_ways, spec.num_shots
        support_im = self._images(parts["support_im"])
        query_im = self._images(parts["query_im"])
        if self.augment_scale > 0.0:
            seed = int(self.rng.randint(0, 2 ** 31))
            shape = support_im.shape
            if support_im.dim() == 5:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                flat = support_im.reshape((B * N * K,) + shape[2:])
                support_im = augment_raw_images(
                    flat, *raw_augment_noise(B * N * K, gen)).reshape(shape)
            else:
                flat = support_im.reshape(B * N * K, -1).contiguous()
                aug_seed = torch.tensor([seed], dtype=torch.int64,
                                        device=self.device)
                support_im = kernels.augment_embeddings(
                    flat, aug_seed, self.augment_scale).reshape(shape)
        return Episode(
            support_im=support_im,
            support_text=self._put(parts["support_text"]),
            # the encoders derive the padding mask from PAD tokens
            support_text_mask=None,
            support_ids=self._put(parts["support_ids"]),
            support_y=self._put(parts["support_y"]),
            query_im=query_im,
            query_ids=self._put(parts["query_ids"]),
            query_y=self._put(parts["query_y"]),
        )

    def sample(self) -> Episode:
        spec = self.spec
        class_idx, sel = self._draw_indices(
            spec.batch_size, spec.num_ways, spec.num_shots, spec.num_query)
        return self._finish(self._assemble_numpy(class_idx, sel))

    def watch_clone(self) -> "HostEpisodeSampler":
        """An independent sampler over the same tables with a derived seed,
        for side-channel episodes that must not shift the training
        stream."""
        clone = HostEpisodeSampler.__new__(HostEpisodeSampler)
        clone.__setstate__(dict(
            self.__getstate__(), seed=self.seed + 0x5EED,
            rng=np.random.RandomState(self.seed + 0x5EED), _counter=0))
        return clone

    def __iter__(self):
        while True:
            yield self.sample()


class _WorkerError:
    """A loader worker's exception on its way to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchingSampler:
    """A background thread that stages ``depth`` episodes of a host
    sampler ahead of the consumer (``--num_workers`` with one worker, the
    numpy backend, or host augmentation). The stream is the wrapped
    sampler's. An exception in the thread is re-raised by the next
    :meth:`sample`, and by every one after it."""

    def __init__(self, sampler: HostEpisodeSampler, depth: int = 2):
        import queue
        import threading
        self.sampler = sampler
        self.spec = sampler.spec
        self._failed: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        import queue
        while not self._stop.is_set():
            try:
                item = self.sampler.sample()
            except BaseException as e:  # noqa: BLE001 - relayed, not hidden
                item = _WorkerError(e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _WorkerError):
                return  # the stream is broken; draw no further

    def sample(self) -> Episode:
        if self._failed is not None:
            raise self._failed
        item = self._q.get()
        if isinstance(item, _WorkerError):
            self._failed = item.exc
            raise item.exc
        return item

    def __iter__(self):
        while True:
            yield self.sample()

    def close(self):
        import queue
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def _mp_worker(sampler: HostEpisodeSampler, w: int, num_workers: int,
               base: int, q, stop) -> None:
    """Loader worker process ``w``: the episodes at counters ``base + w,
    base + w + num_workers, ...`` (counter-addressed native draws and
    numpy assembly; no tensor and no CUDA call, so a fork after the parent
    touched the card is safe), sent as numpy parts. An exception rides the
    queue; one that does not pickle is sent as a ``RuntimeError`` with its
    traceback."""
    import pickle
    import queue
    import traceback

    c = base + w
    while not stop.is_set():
        try:
            class_idx, sel = sampler._indices_at(c)
            item = (c, sampler._assemble_numpy(class_idx, sel))
        except BaseException as e:  # noqa: BLE001 - relayed, not hidden
            try:
                pickle.dumps(e)
            except Exception:
                e = RuntimeError(
                    f"loader worker {w} died:\n" + "".join(
                        traceback.format_exception(type(e), e,
                                                   e.__traceback__)))
            item = _WorkerError(e)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                break
            except queue.Full:
                continue
        if stop.is_set():
            # shutdown: nobody drains the queue, so buffered data must not
            # hold up the process's exit
            q.cancel_join_thread()
            return
        if isinstance(item, _WorkerError):
            return
        c += num_workers


class MultiprocessSampler:
    """``--num_workers N`` loader processes over a native host sampler.

    Episode ``c``'s indices depend only on ``(seed, c)``, so worker ``w``
    computes counters ``w, w + N, w + 2N, ...`` on its own and the consumer
    takes the workers' queues in turn: the stream is exactly the
    single-process one, with assembly in parallel and beside the device's
    work. Workers do numpy and C++ work only; the copy to the device, and
    with it every tensor, is the consumer's (:meth:`HostEpisodeSampler.
    _finish`). ``mp_context`` ``fork`` (default) shares the tables
    copy-on-write; ``spawn`` pickles the sampler into each fresh
    interpreter, whose import of the port initialises no CUDA. Both give
    the same stream.

    Needs the native backend (the numpy backend is a sequential stream)
    and no host augmentation (its seeds come from the sequential stream);
    the driver uses the prefetch thread for those.

    Failure: a worker's exception is re-raised by :meth:`sample`, after
    the episodes before it; a worker that dies without a word raises
    instead of hanging. Reader threads do the blocking reads of the
    workers' pipes and hand complete items on, so :meth:`sample` waits
    with a timeout and checks that the worker lives.
    """

    def __init__(self, sampler: HostEpisodeSampler, num_workers: int,
                 depth: int = 2, mp_context: str = "fork"):
        import multiprocessing as mp
        import queue
        import threading
        if sampler._native is None:
            raise ValueError(
                "MultiprocessSampler needs the native (counter-addressed) "
                "sampler backend; the numpy backend is a sequential stream")
        if sampler.augment_scale > 0.0:
            raise ValueError(
                "MultiprocessSampler does not support host-side "
                "augmentation (sequential seed stream); use the prefetch "
                "thread or the device sampler")
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if mp_context not in ("fork", "spawn"):
            raise ValueError(f"mp_context must be fork|spawn, got "
                             f"{mp_context!r}")
        self.sampler = sampler
        self.spec = sampler.spec
        self.num_workers = num_workers
        ctx = mp.get_context(mp_context)
        self._stop = ctx.Event()
        self._tstop = threading.Event()
        self._base = sampler._counter
        self._next = self._base
        self._queues = [ctx.Queue(maxsize=max(1, depth))
                        for _ in range(num_workers)]
        # bounded at 1, so backpressure reaches the workers
        self._out = [queue.Queue(maxsize=1) for _ in range(num_workers)]
        self._failed: Optional[BaseException] = None
        self._procs = [
            ctx.Process(target=_mp_worker,
                        args=(sampler, w, num_workers, self._base,
                              self._queues[w], self._stop), daemon=True)
            for w in range(num_workers)]
        for p in self._procs:
            p.start()
        self._readers = [threading.Thread(target=self._reader_loop,
                                          args=(w,), daemon=True)
                         for w in range(num_workers)]
        for t in self._readers:
            t.start()

    def _reader_loop(self, w: int) -> None:
        import queue
        while not self._tstop.is_set():
            try:
                item = self._queues[w].get(timeout=0.2)
            except queue.Empty:
                continue
            except (EOFError, OSError) as e:
                item = _WorkerError(RuntimeError(
                    f"loader worker {w} queue broke: {e!r}"))
            while not self._tstop.is_set():
                try:
                    self._out[w].put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _WorkerError):
                return

    def sample(self) -> Episode:
        import queue
        if self._failed is not None:
            raise self._failed
        w = (self._next - self._base) % self.num_workers
        while True:
            try:
                item = self._out[w].get(timeout=1.0)
                break
            except queue.Empty:
                if not self._procs[w].is_alive():
                    # one grace read: the reader may still hand on an item
                    # the worker finished before it died
                    try:
                        item = self._out[w].get(timeout=0.5)
                        break
                    except queue.Empty:
                        pass
                    self._failed = RuntimeError(
                        f"loader worker {w} died without reporting "
                        f"(exit code {self._procs[w].exitcode})")
                    raise self._failed
        if isinstance(item, _WorkerError):
            self._failed = item.exc
            raise item.exc
        c, parts = item
        if c != self._next:
            raise RuntimeError(f"loader stream out of order: episode {c}, "
                               f"expected {self._next}")
        # the wrapped sampler's counter follows consumption; a direct draw
        # from it while this loader lives would be replayed, so it raises
        if self.sampler._counter != self._next:
            raise RuntimeError(
                f"base sampler drawn directly while MultiprocessSampler "
                f"is live (base counter {self.sampler._counter}, stream "
                f"at {self._next}); unwrap only after close()")
        self._next += 1
        self.sampler._counter = self._next
        return self.sampler._finish(parts)

    def __iter__(self):
        while True:
            yield self.sample()

    def close(self):
        # the workers leave through the stop event; the mp queues are
        # never drained here (a read of a half-written message blocks)
        self._stop.set()
        self._tstop.set()
        for p in self._procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        for q in self._queues:
            q.cancel_join_thread()
            q.close()
        for t in self._readers:
            t.join(timeout=2.0)
