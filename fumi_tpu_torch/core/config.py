"""Typed experiment configuration and its argparse adapter.

A copy of ``fumi_tpu/core/config.py``: ``Config`` with the same fields,
defaults, ``validate()`` checks and ``replace``; ``build_parser`` with the
same flags and defaults; ``config_from_args`` and ``config_from_json``.
The port keeps its own copy because importing anything under ``fumi_tpu``
pulls in JAX. ``tests/test_torch_isolation.py`` and
``tests/test_torch_cli.py`` hold the copy equal to the JAX package's.

Fields that only the JAX package's TPU engines read (mesh, chunking,
remat, PRNG implementation, ...) are kept so that a config means the same
thing on both sides; the port's entry points reject the values they do
not implement, naming the ROADMAP.md item that will port each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from typing import Optional, Tuple

TEXT_ENCODERS = ("glove", "w2v", "RNN", "RNNhid", "BERT", "rand", "precomputed")
# encoders whose wire format is int token ids (vs precomputed float embeddings)
TOKEN_TEXT_ENCODERS = ("glove", "w2v", "RNN", "RNNhid")
TEXT_TYPES = ("label", "description", "common_name")
MODELS = ("maml", "fumi", "am3", "clip")
OPTIMIZERS = ("adam", "SGD", "adamw", "adamw_lin_schedule")
# families the JAX package registers beside MODELS (its train/steps.py
# register_family); the port accepts their names and its entry points
# reject them until they are ported (ROADMAP.md Queue 1, item 5)
REGISTERED_FAMILIES = ("protonet", "matchingnet")


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
        outside ``MODELS`` and the JAX package's ``REGISTERED_FAMILIES``
        is rejected."""
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
        if self.model not in MODELS + REGISTERED_FAMILIES:
            raise ValueError(f"unknown model {self.model!r}; one of "
                             f"{MODELS + REGISTERED_FAMILIES}")
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


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser: the reference's flags with their names
    and defaults, plus the ``--tpu_*`` extensions. Every flag parses; the
    port's entry points reject the values they do not run yet."""
    p = argparse.ArgumentParser(description="Multimodal image classification")
    a = p.add_argument

    # data config
    a("--wandb_entity", type=str, default="multimodal-image-cls")
    a("--wandb_project", type=str, default="fumi")
    a("--dataset", type=str, default="inat-anim",
      help="Dataset to use (inat-anim, supervised-inat-anim)")
    a("--data_dir", type=str, default="./data")
    a("--checkpoint", type=str, default=None)
    a("--log_dir", type=str, default="./results")
    a("--remove_stop_words", action="store_true")
    a("--colab", action="store_true")

    # optimizer config
    a("--epochs", type=int, default=50000,
      help="Number of meta-learning batches to train for")
    a("--optim", type=str, default="adam")
    a("--lr", type=float, default=3e-5)
    a("--momentum", type=float, default=0.9)
    a("--batch_size", type=int, default=4,
      help="Number of tasks in mini-batch")
    a("--weight_decay", type=float, default=5e-4)
    a("--num_warmup_steps", type=int, default=10)

    # dataloader config
    a("--num_shots", type=int, default=5)
    a("--num_ways", type=int, default=5)
    a("--num_shots_test", type=int, default=32,
      help="Number of examples per class in query set")
    a("--augment", action="store_true")
    a("--num_workers", type=int, default=0)
    a("--image_embedding_model", type=str, default="resnet-152")

    # model config
    a("--model", type=str, default="fumi")
    a("--prototype_dim", type=int, default=64)
    a("--im_encoder", type=str, default="precomputed")
    a("--im_emb_dim", type=int, default=2048)
    a("--im_hid_dim", type=int, nargs="+", default=[256, 64])
    a("--text_encoder", type=str, default="BERT", choices=list(TEXT_ENCODERS))
    a("--pooling_strat", type=str, default="mean")
    a("--fine_tune", action="store_true")
    a("--text_type", type=str, nargs="+", default=["description"])
    a("--text_emb_dim", type=int, default=768)
    a("--text_hid_dim", type=int, default=256)
    a("--dropout", type=float, default=0.25)
    a("--step_size", type=float, default=0.01)
    a("--first_order", action="store_true")
    a("--num_train_adapt_steps", type=int, default=5)
    a("--num_test_adapt_steps", type=int, default=100)
    a("--init_all_layers", action="store_true")
    a("--norm_hypernet", action="store_true")
    a("--hypernet_bias_init", action="store_true")
    a("--lamda_fixed", default=None, type=int)

    # clip config
    a("--clip_latent_dim", type=int, default=512)

    # run config
    a("--seed", type=int, default=123)
    a("--patience", type=int, default=10000)
    a("--eval_freq", type=int, default=2500)
    a("--wandb_experiment", type=str, default="debug")
    a("--evaluate", action="store_true")
    a("--num_ep_test", type=int, default=1000)
    a("--disable_cuda", action="store_true",
      help="run on the CPU (the port runs on the GPU otherwise)")
    a("--wandb_offline", action="store_true")

    # extensions of the JAX package
    a("--tpu_mesh_dp", type=int, default=0,
      help="episode-parallel mesh axis size (0 = all devices)")
    a("--tpu_mesh_mp", type=int, default=1, help="model mesh axis size")
    a("--tpu_host_sampler", action="store_true",
      help="host-side episodic sampler instead of the device sampler")
    a("--tpu_sampler_backend", type=str, default="auto",
      choices=["auto", "native", "numpy"], help="host-sampler index backend")
    a("--tpu_loader_mp_context", type=str, default="fork",
      choices=["fork", "spawn"],
      help="start method for --num_workers loader processes")
    a("--tpu_chunk", type=int, default=0,
      help="train steps per driver call (0 = 1000)")
    a("--tpu_train_unroll", type=int, default=0,
      help="outer-scan unroll of the JAX package's chunked train drivers")
    a("--tpu_grad_accum", type=int, default=1,
      help="compute each meta-gradient in this many micro-batches")
    a("--tpu_allow_replacement", action="store_true",
      help="sample with replacement from classes with fewer than K+Q "
           "images instead of failing fast")
    a("--tpu_pallas_gather", action="store_true",
      help="gather episode rows with the hand-written kernel")
    a("--tpu_pallas_fused_eval", action="store_true",
      help="run eval adaptation through the fused kernels")
    a("--tpu_compute_dtype", type=str, default="float32",
      choices=["float32", "bfloat16"])
    a("--tpu_prng_impl", type=str, default="rbg",
      choices=["rbg", "threefry2x32", "unsafe_rbg"])
    a("--tpu_skip_nonfinite", type=int, default=0,
      help="skip non-finite meta-updates; abort after N in a row (0 = off)")
    a("--tpu_im_size", type=int, default=84)
    a("--tpu_im_channels", type=int, default=3)
    a("--tpu_resnet12_channels", type=int, nargs="+",
      default=[64, 160, 320, 640])
    a("--tpu_meta_grad", type=str, default="explicit",
      choices=["explicit", "imaml", "reptile"])
    a("--tpu_imaml_lambda", type=float, default=2.0)
    a("--tpu_imaml_cg_iters", type=int, default=5)
    a("--tpu_adapt_params", type=str, default="all", choices=["all", "head"])
    a("--tpu_remat", type=str, default="auto", choices=["auto", "on", "off"])
    a("--tpu_ema", type=float, default=0.0)
    a("--tpu_watch", action="store_true")
    a("--tpu_debug_nans", action="store_true")
    a("--tpu_profile_dir", type=str, default=None)
    a("--tpu_auto_resume", action="store_true",
      help="resume the newest checkpointed run in log_dir (params, "
           "optimizer state, batch counter)")
    a("--tpu_seed_sweep", type=int, default=0)
    a("--tpu_seed_accum", type=int, default=1)
    a("--tpu_import", type=str, nargs="+", default=[])
    a("--tpu_dist_coordinator", type=str, default=None)
    a("--tpu_dist_num_processes", type=int, default=0)
    a("--tpu_dist_process_id", type=int, default=-1)
    return p


# Config fields whose flag is not the field's name
_FLAG_OF = {"mesh_dp": "tpu_mesh_dp", "mesh_mp": "tpu_mesh_mp",
            "sampler_backend": "tpu_sampler_backend",
            "loader_mp_context": "tpu_loader_mp_context",
            "chunk": "tpu_chunk", "train_unroll": "tpu_train_unroll",
            "grad_accum": "tpu_grad_accum",
            "allow_replacement": "tpu_allow_replacement",
            "pallas_gather": "tpu_pallas_gather",
            "pallas_fused_eval": "tpu_pallas_fused_eval",
            "compute_dtype": "tpu_compute_dtype",
            "prng_impl": "tpu_prng_impl",
            "skip_nonfinite": "tpu_skip_nonfinite", "im_size": "tpu_im_size",
            "im_channels": "tpu_im_channels",
            "resnet12_channels": "tpu_resnet12_channels",
            "meta_grad": "tpu_meta_grad", "imaml_lambda": "tpu_imaml_lambda",
            "imaml_cg_iters": "tpu_imaml_cg_iters",
            "adapt_params": "tpu_adapt_params", "remat": "tpu_remat",
            "ema": "tpu_ema", "watch": "tpu_watch",
            "debug_nans": "tpu_debug_nans", "profile_dir": "tpu_profile_dir",
            "auto_resume": "tpu_auto_resume", "seed_sweep": "tpu_seed_sweep",
            "seed_accum": "tpu_seed_accum", "import_modules": "tpu_import",
            "dist_coordinator": "tpu_dist_coordinator",
            "dist_num_processes": "tpu_dist_num_processes",
            "dist_process_id": "tpu_dist_process_id"}


def _is_tuple_field(field: dataclasses.Field) -> bool:
    return (typing.get_origin(field.type) is tuple
            if not isinstance(field.type, str) else "Tuple" in field.type)


def config_from_args(argv=None) -> Config:
    """Parse ``argv`` into a validated Config. Unlike the JAX package, it
    imports nothing for ``--tpu_import`` (the port has no family registry
    to extend; its driver rejects the flag)."""
    args = vars(build_parser().parse_args(argv))
    kwargs = {}
    for field in dataclasses.fields(Config):
        if field.name == "device_sampler":
            kwargs[field.name] = not args["tpu_host_sampler"]
            continue
        val = args[_FLAG_OF.get(field.name, field.name)]
        kwargs[field.name] = tuple(val) if _is_tuple_field(field) else val
    return Config(**kwargs).validate()


def config_from_json(path: str) -> Config:
    """Rebuild a Config from a run dir's ``config.json`` (the driver writes
    ``dataclasses.asdict(cfg)`` there): JSON lists back to the tuple
    fields, unknown keys ignored, validated."""
    with open(path) as f:
        raw = json.load(f)
    kwargs = {}
    for field in dataclasses.fields(Config):
        if field.name not in raw:
            continue
        val = raw[field.name]
        if isinstance(val, list) and _is_tuple_field(field):
            val = tuple(val)
        kwargs[field.name] = val
    return Config(**kwargs).validate()
