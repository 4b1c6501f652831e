"""Typed experiment configuration (no argparse builder).

A copy of ``fumi_tpu/core/config.py``'s ``Config``: the same fields with
the same defaults, the same ``validate()`` checks and ``replace``. The port
keeps its own copy because importing anything under ``fumi_tpu`` pulls in
JAX. ``tests/test_torch_isolation.py`` holds the defaults equal to the JAX
package's. The argparse builder and ``config_from_json`` are not copied:
the port has no CLI yet (ROADMAP.md, Queue 1).

Fields that only the JAX package's TPU engines read (mesh, chunking,
remat, PRNG implementation, ...) are kept so that a config means the same
thing on both sides; the port's entry points reject the values they do
not implement.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

TEXT_ENCODERS = ("glove", "w2v", "RNN", "RNNhid", "BERT", "rand", "precomputed")
# encoders whose wire format is int token ids (vs precomputed float embeddings)
TOKEN_TEXT_ENCODERS = ("glove", "w2v", "RNN", "RNNhid")
TEXT_TYPES = ("label", "description", "common_name")
MODELS = ("maml", "fumi", "am3", "clip")
OPTIMIZERS = ("adam", "SGD", "adamw", "adamw_lin_schedule")


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen experiment config. Field names mirror reference CLI flags."""

    # wandb / logging surface
    wandb_entity: str = "multimodal-image-cls"
    wandb_project: str = "fumi"
    wandb_experiment: str = "debug"
    wandb_offline: bool = False

    # data config
    dataset: str = "inat-anim"
    data_dir: str = "./data"
    checkpoint: Optional[str] = None
    log_dir: str = "./results"
    remove_stop_words: bool = False
    colab: bool = False

    # optimizer config
    epochs: int = 50000  # number of meta-batches for episodic models
    optim: str = "adam"
    lr: float = 3e-5
    momentum: float = 0.9
    batch_size: int = 4  # tasks per meta-batch
    weight_decay: float = 5e-4
    num_warmup_steps: int = 10

    # dataloader config
    num_shots: int = 5
    num_ways: int = 5
    num_shots_test: int = 32  # query size on the *train* split
    augment: bool = False
    num_workers: int = 0
    image_embedding_model: str = "resnet-152"

    # model config
    model: str = "fumi"
    prototype_dim: int = 64
    im_encoder: str = "precomputed"
    im_emb_dim: int = 2048
    im_hid_dim: Tuple[int, ...] = (256, 64)
    text_encoder: str = "BERT"
    pooling_strat: str = "mean"
    fine_tune: bool = False
    text_type: Tuple[str, ...] = ("description",)
    text_emb_dim: int = 768
    text_hid_dim: int = 256
    dropout: float = 0.25
    step_size: float = 0.01
    first_order: bool = False
    num_train_adapt_steps: int = 5
    num_test_adapt_steps: int = 100
    init_all_layers: bool = False
    norm_hypernet: bool = False
    hypernet_bias_init: bool = False
    lamda_fixed: Optional[int] = None

    # clip config
    clip_latent_dim: int = 512

    # run config
    seed: int = 123
    patience: int = 10000
    eval_freq: int = 2500
    evaluate: bool = False
    num_ep_test: int = 1000
    disable_cuda: bool = False

    # extensions of the JAX package (absent from the reference)
    mesh_dp: int = 0
    mesh_mp: int = 1
    device_sampler: bool = True
    sampler_backend: str = "auto"
    loader_mp_context: str = "fork"
    chunk: int = 0
    train_unroll: int = 0
    grad_accum: int = 1
    allow_replacement: bool = False
    pallas_gather: bool = False
    pallas_fused_eval: bool = False
    compute_dtype: str = "float32"
    prng_impl: str = "rbg"
    im_size: int = 84
    im_channels: int = 3
    resnet12_channels: Tuple[int, ...] = (64, 160, 320, 640)
    meta_grad: str = "explicit"
    imaml_lambda: float = 2.0
    imaml_cg_iters: int = 5
    adapt_params: str = "all"
    remat: str = "auto"
    ema: float = 0.0
    watch: bool = False
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    skip_nonfinite: int = 0
    auto_resume: bool = False
    seed_sweep: int = 0
    seed_accum: int = 1
    import_modules: Tuple[str, ...] = ()
    dist_coordinator: Optional[str] = None
    dist_num_processes: int = 0
    dist_process_id: int = -1

    # ------------------------------------------------------------------
    @property
    def num_query_train(self) -> int:
        """Query-set size per class on the train split."""
        return self.num_shots_test

    @property
    def num_query_eval(self) -> int:
        """Query size per class on val/test splits."""
        return int(100 / self.num_ways)

    @property
    def max_test_batches(self) -> int:
        return int(self.num_ep_test / self.batch_size)

    def validate(self) -> "Config":
        """The JAX package's argument validation, check for check.

        The one difference: the port has no family registry, so a model
        outside ``MODELS`` is always rejected."""
        if "inat" in self.dataset and \
                self.im_encoder not in ("conv4", "resnet12"):
            if self.image_embedding_model not in ("resnet-152", "resnet-34"):
                raise ValueError(
                    "Image embedding model must be one of resnet-152 "
                    "resnet-34")
            if self.image_embedding_model == "resnet-152" and \
                    self.im_emb_dim != 2048:
                raise ValueError(
                    "Resnet-152 outputs 2048-dimensional embeddings, hence "
                    "--im_emb_dim should be set to 2048")
            if self.image_embedding_model == "resnet-34" and \
                    self.im_emb_dim != 512:
                raise ValueError(
                    "Resnet-34 outputs 512-dimensional embeddings, hence "
                    "--im_emb_dim should be set to 512")
        if self.model not in MODELS:
            raise ValueError(f"unknown model {self.model!r}; one of {MODELS}")
        if self.text_encoder not in TEXT_ENCODERS:
            raise NameError(
                f"{self.text_encoder} not allowed as text encoder")
        if self.im_encoder not in ("precomputed", "resnet", "conv4",
                                   "resnet12"):
            raise NameError(
                f"{self.im_encoder} not allowed as image encoder")
        for t in self.text_type:
            if t not in TEXT_TYPES:
                raise NameError("Invalid text type used")
        if self.optim not in OPTIMIZERS:
            raise NotImplementedError(f"optimizer {self.optim!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"--tpu_compute_dtype {self.compute_dtype!r} "
                "(float32|bfloat16)")
        if self.sampler_backend not in ("auto", "native", "numpy"):
            raise ValueError(
                f"--tpu_sampler_backend {self.sampler_backend!r} "
                "(auto|native|numpy)")
        if self.loader_mp_context not in ("fork", "spawn"):
            raise ValueError(
                f"--tpu_loader_mp_context {self.loader_mp_context!r} "
                "(fork|spawn)")
        if self.chunk < 0 or self.train_unroll < 0:
            raise ValueError("--tpu_chunk/--tpu_train_unroll must be >= 0 "
                             "(0 = auto)")
        if self.grad_accum < 1:
            raise ValueError("--tpu_grad_accum must be >= 1")
        if self.grad_accum > 1:
            if self.batch_size % self.grad_accum != 0:
                raise ValueError(
                    f"--tpu_grad_accum {self.grad_accum} must divide "
                    f"--batch_size {self.batch_size}")
            if not self.device_sampler:
                raise NotImplementedError(
                    "--tpu_grad_accum requires the device sampler "
                    "(drop --tpu_host_sampler)")
            if self.mesh_mp > 1:
                raise NotImplementedError(
                    "--tpu_grad_accum > 1 is not wired into the 2-D (mp) "
                    "engine — use --tpu_mesh_mp 1")
        if self.meta_grad not in ("explicit", "imaml", "reptile"):
            raise ValueError(
                f"meta_grad {self.meta_grad!r} (explicit|imaml|reptile)")
        if self.adapt_params not in ("all", "head"):
            raise ValueError(
                f"adapt_params {self.adapt_params!r} (all|head)")
        if self.remat not in ("auto", "on", "off"):
            raise ValueError(f"--tpu_remat {self.remat!r} (auto|on|off)")
        if self.meta_grad != "explicit" and self.adapt_params == "head":
            raise NotImplementedError(
                f"--tpu_meta_grad {self.meta_grad} with "
                "--tpu_adapt_params head")
        if not 0.0 <= self.ema < 1.0:
            raise ValueError(
                f"--tpu_ema {self.ema} must be in [0, 1) (0 = off)")
        meta_grad_models = {"imaml": ("maml", "fumi"), "reptile": ("maml",)}
        if self.meta_grad != "explicit":
            allowed = meta_grad_models[self.meta_grad]
            if self.model not in allowed:
                raise NotImplementedError(
                    f"--tpu_meta_grad {self.meta_grad} supports "
                    f"--model {allowed} only (got {self.model})")
        if self.model == "fumi" and self.meta_grad == "imaml" \
                and self.dropout > 0:
            raise NotImplementedError(
                "--model fumi --tpu_meta_grad imaml runs the inner solve "
                "and query forward WITHOUT dropout; pass --dropout 0 to "
                "acknowledge")
        if self.adapt_params != "all" and self.model != "maml":
            raise NotImplementedError(
                "--tpu_adapt_params applies to the MAML family only "
                f"(got --model {self.model})")
        if self.seed_sweep < 0:
            raise ValueError("--tpu_seed_sweep must be >= 0 (0/1 = off)")
        if self.seed_sweep > 1:
            if self.model == "clip":
                raise NotImplementedError(
                    "--tpu_seed_sweep covers the episodic families only")
            if not self.device_sampler:
                raise NotImplementedError(
                    "--tpu_seed_sweep requires the device sampler")
            if self.mesh_mp > 1:
                raise NotImplementedError(
                    "--tpu_seed_sweep shards over the seed axis; "
                    "--tpu_mesh_mp is not supported with it")
            if self.mesh_dp > 1 and self.seed_sweep % self.mesh_dp != 0:
                raise ValueError(
                    f"--tpu_seed_sweep {self.seed_sweep} must be a "
                    f"multiple of --tpu_mesh_dp {self.mesh_dp}")
            if self.checkpoint or self.evaluate:
                raise NotImplementedError(
                    "--tpu_seed_sweep trains fresh replicas; "
                    "--checkpoint/--evaluate are single-run modes")
            if (self.dist_coordinator is not None
                    or self.dist_num_processes > 0):
                raise NotImplementedError(
                    "--tpu_seed_sweep does not support multi-host runs")
        if self.seed_accum < 1:
            raise ValueError("--tpu_seed_accum must be >= 1")
        if self.seed_accum > 1:
            if self.seed_sweep <= 1:
                raise ValueError(
                    "--tpu_seed_accum groups a sweep's seed axis; it "
                    "needs --tpu_seed_sweep > 1")
            if self.seed_sweep % self.seed_accum != 0:
                raise ValueError(
                    f"--tpu_seed_accum {self.seed_accum} must divide "
                    f"--tpu_seed_sweep {self.seed_sweep}")
            if self.mesh_dp > 1:
                raise NotImplementedError(
                    "--tpu_seed_accum is the single-device sweep's "
                    "working-set lever; drop --tpu_mesh_dp")
        return self

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
