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

Raw-image tables and their flip-and-crop augmentation wait for the
raw-image backbones (ROADMAP.md Queue 1, item 7); the host samplers wait
for the harness (item 4b); bf16 table storage for the bf16 policy (item 8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
    image_table: torch.Tensor  # (num_images, D)
    image_ids: torch.Tensor  # (num_images,) int32
    class_rows: torch.Tensor  # (C, max_count) int32
    class_counts: torch.Tensor  # (C,) int32
    text_features: torch.Tensor  # (C, E)


def episode_from_noise(tables: SamplerTables, spec: EpisodeSpec,
                       cls_noise: torch.Tensor, img_noise: torch.Tensor,
                       aug_noise: Optional[torch.Tensor] = None,
                       use_pallas_gather: bool = False,
                       aug_seed: Optional[torch.Tensor] = None,
                       augment_scale: float = 0.0) -> Episode:
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
    give bitwise the same episode."""
    if aug_noise is not None and aug_seed is not None:
        raise ValueError("episode_from_noise: aug_noise or aug_seed, not both")
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
    jitter = aug_noise is not None or (aug_seed is not None
                                       and augment_scale > 0.0)
    if jitter and table.dim() != 2:
        raise NotImplementedError(
            "raw-image augmentation is not ported yet (ROADMAP.md "
            "Queue 1, item 7: raw-image backbones)")
    seeded = jitter and aug_noise is None
    if use_pallas_gather and table.dim() == 2:
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

    # per-class text repeated per shot, class-major like the targets
    text_cls = tables.text_features[class_idx]  # (B, N, E)
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
    aug_seed = None
    if augment_scale > 0.0:
        aug_seed = torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 dtype=torch.int64, device=dev)
    return episode_from_noise(tables, spec, cls_noise, img_noise,
                              use_pallas_gather=use_pallas_gather,
                              aug_seed=aug_seed, augment_scale=augment_scale)


class DeviceEpisodeSampler:
    """On-device episodic sampler over one split.

    Args:
      image_table: (num_images, D) image embeddings (numpy or tensor).
      image_ids:   (num_images,) row -> raw image id.
      class_set:   the split's ClassSet.
      spec:        episode geometry.
      use_pallas_gather: gather image rows with the CUDA kernel
                   (``--tpu_pallas_gather``).
      augment_scale: support-embedding jitter scale (0 = off).
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
