"""Trainers of the port (port of gaot3d_tpu/train/trainer.py `TrainerBase`,
`StaticTrainer3D`, `init_trainer`).

  - config, seeding, loss = masked MSE (`train/step.py`)
  - dataset init: latent token grid from the metadata domain rescaled with the
    scalar min-max, normalization stats computed from the train split or
    loaded from cache, the precompute sweep, split loaders
  - fit(): epoch loop with per-epoch shuffling, eval every `eval_every_eps`
    epochs, best state by train or val metric restored at the end, loss
    curves, the checkpoint
  - validate(): batch-mean losses summed and divided by the dataset size (the
    reference's sum-of-batch-means over number-of-samples quirk, kept)
  - test(): timed inference with the data-versus-inference split,
    de-normalization, the three metric suites, npz dump and a 3D render of the
    first sample
  - one CSV datarow with the JAX trainer's columns

Everything runs on `setup.device` (`config.resolve_device`): the card unless
the config says `cpu`. Batches are assembled on the host by `data/pipeline.py`
and uploaded through pinned memory by a prefetch thread; a step is
`train/step.py` `train_step`, so the kernels of `kernels/` run on CUDA tensors
and their plain versions on CPU tensors. One `torch.Generator` on the device,
seeded from `setup.seed`, feeds attention dropout and the edge sampling of
`magno.sampling_strategy`, and a second one, seeded
from `setup.seed` + 1, the neural-field node sampler, so that a step's dropout
seeds do not depend on the strategy.

Edges come from one of three places, as in the JAX trainer: the precompute
sweep (`update_pt_files_with_edges`), the loader's host build
(`asynchronous_graph_building`), or, with neither, the model itself, which
builds uniform slots on the device inside every forward (slot mode
'device'). `training_strategy: neural_field` samples nodes on the device and
builds the edges of the sampled coordinates, so it needs that last mode.

`setup.dtype: bfloat16` follows the JAX trainer's rule: it turns a float32
`magno.kernel_dtype` into bfloat16 (the GNO kernel MLPs in bf16) and leaves
an explicit one alone; parameters and AdamW state stay f32, and attention is
bf16 either way (`attention_dtype`).

`setup.distributed` runs one process a rank over torch.distributed
(`parallel/`): `data_parallel` ranks hold different samples, `node_shards`
ranks the node shards of the same samples (rank = data_rank * node_shards +
node_rank), started from torchrun's variables or from `world_size`, `rank`
and `coordinator_address`; one process with world 1 runs as an
undistributed trainer does. As in the JAX trainer:
  - Python, numpy and torch's global state are seeded with seed + rank; the
    weights and the step's randomness (dropout seeds, edge sampling,
    neural-field draws) come from generators seeded alike on every rank;
  - the train and val loaders are sharded by data rank (num_shards =
    data_parallel), the test loader is not: every rank runs the whole test
    set, its node shards gathered;
  - sectioned slots are shard-aligned (`section_shards = node_shards`; the
    padded node count must split over the node ranks);
  - the precompute sweep runs on rank 0 while the others wait;
  - the loss of a step is the global masked mean;
  - validate over the sharded val loader sums each data rank's batch mean
    (the reference's partitioning quirk);
  - checkpoints, plots, npz files and the CSV row are written by rank 0.
The JAX trainer's layout harvest, host staging by node count and compilation
cache answer to XLA and have no counterpart here.
"""
from __future__ import annotations

import json
import logging
import os
import statistics
import time
from dataclasses import asdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import RunConfig, resolve_device
from ..data.dataset import (DatasetConfig, MeshDataset, compute_or_load_stats,
                            generate_synthetic_dataset)
from ..data.host_graph import build_edge_slots_host
from ..data.pipeline import (BatchLoader, SamplePreprocessor, pinned_to_device,
                             prefetch_to_device)
from ..edges import LatentGrid, parse_edge_layout, parse_neighbor_strategy
from ..metadata import DATASET_METADATA
from ..models import init_model
from ..parallel import (Placement, gather_rows, initialize_distributed, make_mesh,
                        make_sharded_train_step, placed, shard_point_batch)
from ..parallel.mesh import local_rank
from ..utils.rand import manual_seed
from .checkpoint import load_checkpoint, load_trained_params, save_checkpoint
from .metrics import compute_drivaernet_metric, compute_general_metrics, compute_poseidon_metric
from .schedule import make_optimizer
from .step import NeuralField, TrainBatch, eval_step, train_step

logger = logging.getLogger(__name__)


def _process_rss_gb() -> float:
    """Resident set size of this process in GB, read from /proc."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, ValueError, IndexError):  # not a Linux host
        return 0.0


def _edges_to_device(edges, device, memo: dict):
    """One scale's edge structure (CPU tensors) on `device`; `memo` keeps
    aliased encoder and decoder structures one set of device tensors."""
    if id(edges) not in memo:
        memo[id(edges)] = edges.map(lambda t: pinned_to_device(t, device, memo))
    return memo[id(edges)]


class TrainerBase:
    """Config plumbing, seeding, optional wandb, checkpoints and the fit/test
    orchestration."""

    def __init__(self, config: RunConfig):
        self.config = config
        self.setup_config = config.setup
        self.model_config = config.model
        self.dataset_config = config.dataset
        self.optimizer_config = config.optimizer
        self.path_config = config.path
        self.datarow: Dict[str, Any] = {}
        self._last_grad_norm = None
        # per-epoch loader accounting (set by optimize(); see
        # prefetch_to_device): steady-state stall past the warm-up batch, and
        # the warm-up wait itself
        self.last_loader_stall_s = 0.0
        self.last_loader_first_wait_s = 0.0
        self.last_loader_stats: Dict[str, float] = {}

        setup = self.setup_config
        self.device = resolve_device(setup.device)
        self.mesh = None
        if setup.distributed:
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda", local_rank(setup))
            initialize_distributed(setup, self.device)
            self.mesh = make_mesh(setup.data_parallel, max(1, setup.node_shards))
        elif setup.world_size > 1:
            raise ValueError("setup.world_size > 1 needs setup.distributed: true")
        self.rank = 0 if self.mesh is None else self.mesh.rank
        self.num_processes = 1 if self.mesh is None else self.mesh.world
        self.is_main = self.rank == 0
        # node sharding splits every sample's points over the node ranks
        self.shard_nodes = self.mesh is not None and self.mesh.node > 1
        # a sharded step over the rank's rows, which put_batch has cut already
        self._train_step = train_step if self.mesh is None else make_sharded_train_step(
            train_step, self.mesh, process_local=True)
        manual_seed(setup.seed + self.rank)
        # the same on every rank: the weights, and the step's randomness (the
        # global batch draws it once; each rank takes its rows' part).
        # Weights are drawn on the CPU and moved; dropout seeds on the device
        self.init_generator = torch.Generator().manual_seed(setup.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(setup.seed)
        self.sample_generator = torch.Generator(device=self.device).manual_seed(setup.seed + 1)

        self.metadata = DATASET_METADATA[self.dataset_config.metaname]
        self._wandb = None
        self._init_wandb()
        self.init_dataset(self.dataset_config)
        self.init_model(self.model_config)
        self.init_optimizer(self.optimizer_config)
        self.datarow["nparams"] = self.num_params
        self.datarow["nbytes"] = self.num_bytes

    # -- observability -----------------------------------------------------
    def _init_wandb(self):
        """wandb is optional: imported only when the config turns it on (rank
        0 only)."""
        if not self.setup_config.wandb or not self.is_main:
            return
        try:
            import wandb

            self._wandb = wandb
            wandb.init(
                project=self.setup_config.wandb_project,
                entity=self.setup_config.wandb_entity,
                name=self.setup_config.wandb_run_name,
                group=self.setup_config.wandb_group,
                mode=self.setup_config.wandb_mode,
                notes=self.setup_config.wandb_notes,
                tags=list(self.setup_config.wandb_tags),
                config=asdict(self.config),
            )
        except Exception as e:  # pragma: no cover
            logger.warning("wandb init failed (%s); continuing without wandb", e)
            self._wandb = None

    def log_metrics(self, metrics: Dict[str, float], step: int):
        if self._wandb is not None:
            try:
                self._wandb.log(metrics, step=step)
            except Exception as e:  # pragma: no cover
                logger.warning("wandb log failed: %s", e)

    # -- model/optimizer ----------------------------------------------------
    def init_dataset(self, dataset_config: DatasetConfig):
        raise NotImplementedError

    def init_model(self, model_config):
        raise NotImplementedError

    def init_optimizer(self, optimizer_config):
        loader = getattr(self, "train_loader", None)
        steps_per_epoch = max(1, len(loader)) if loader else 1
        self.optimizer = make_optimizer(optimizer_config.name, self.model.parameters(),
                                        optimizer_config.args, steps_per_epoch)

    # -- checkpoint artifacts --------------------------------------------------
    def _artifact_paths(self):
        base = self.path_config.ckpt_path
        art_dir = os.path.join(os.path.dirname(base) or ".", "artifacts")
        name, ext = os.path.splitext(os.path.basename(base))
        return art_dir, name, ext, os.path.join(art_dir, f"{name}-aliases.json")

    def save_checkpoint_artifact(self, epoch: int, train_loss: float, val_loss: float,
                                 is_best: bool = False):
        """Versioned checkpoint artifacts with 'latest' / 'best' aliases and
        loss and epoch metadata, in a directory next to the checkpoint path
        (and to W&B when it is on); rank 0 only."""
        if not self.is_main:
            return
        art_dir, name, ext, meta_path = self._artifact_paths()
        os.makedirs(art_dir, exist_ok=True)
        version_path = os.path.join(art_dir, f"{name}-e{epoch}{ext}")
        self.save_ckpt(version_path, extra={"epoch": epoch})
        aliases = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                aliases = json.load(f)
        record = {"path": version_path, "epoch": epoch,
                  "train_loss": float(train_loss), "val_loss": float(val_loss)}
        aliases["latest"] = record
        if is_best:
            aliases["best"] = record
        with open(meta_path, "w") as f:
            json.dump(aliases, f, indent=1)
        if self._wandb is not None:
            try:
                art = self._wandb.Artifact(
                    f"model-{name}", type="model",
                    metadata={k: v for k, v in record.items() if k != "path"})
                art.add_file(version_path)
                self._wandb.log_artifact(
                    art, aliases=["latest", "best"] if is_best else ["latest"])
            except Exception as e:  # pragma: no cover
                logger.warning("wandb artifact save failed: %s", e)

    def load_from_artifact(self, spec: str):
        """Load 'name:alias' from W&B, or an alias ('best' / 'latest') from
        the local artifact directory."""
        alias = spec.split(":")[-1] if ":" in spec else spec
        if self._wandb is not None and ":" in spec:
            try:
                path = self._wandb.use_artifact(spec).download()
                files = [f for f in os.listdir(path) if f.endswith((".pt", ".msgpack"))]
                self.load_ckpt(os.path.join(path, files[0]))
                return
            except Exception as e:  # pragma: no cover
                logger.warning("wandb artifact load failed (%s); trying local", e)
        with open(self._artifact_paths()[3]) as f:
            aliases = json.load(f)
        self.load_ckpt(aliases[alias]["path"])

    # -- checkpointing -------------------------------------------------------
    def save_ckpt(self, path: Optional[str] = None, extra: Optional[Dict] = None):
        if not self.is_main:
            return
        path = path or self.path_config.ckpt_path
        state = {"params": self.model.state_dict(),
                 "opt_state": self.optimizer.optimizer.state_dict(),
                 "step": self.optimizer.count}
        if extra:
            state.update(extra)
        save_checkpoint(path, state)
        logger.info("Saved checkpoint to %s", path)

    def load_ckpt(self, path: Optional[str] = None, params_only: bool = True):
        """Restore the parameters, or with `params_only=False` the optimizer's
        state and step count too. A `.msgpack` path is a JAX trainer's
        checkpoint: its parameters load, its optimizer state cannot."""
        path = path or self.path_config.ckpt_path
        if path.endswith(".msgpack") and not params_only:
            raise ValueError("a JAX .msgpack checkpoint carries no optimizer state "
                             "this package can read: load it with params_only=True")
        if params_only:
            load_trained_params(path, self.model, self.device)
        else:
            state = load_checkpoint(path, self.device)
            self.model.load_state_dict(state["params"])
            self.optimizer.optimizer.load_state_dict(state["opt_state"])
            self.optimizer.count = int(state["step"])
        logger.info("Loaded checkpoint from %s", path)

    # -- orchestration --------------------------------------------------------
    def fit(self):
        result = self.optimize()
        self.datarow["training time"] = result["time"]
        if self.is_main:
            self.plot_losses(result)
        self.save_ckpt()
        if self._wandb is not None:
            try:
                self._wandb.summary.update({"best_epoch": result["best"]["epoch"],
                                            "best_loss": result["best"]["loss"]})
            except Exception:  # pragma: no cover
                pass
        if self.setup_config.test:
            self.test()
        return result

    def plot_losses(self, result: Dict):
        """Loss curves as NPZ, and as PNG when matplotlib is installed."""
        path = self.path_config.loss_path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(
            path.rsplit(".", 1)[0] + ".npz",
            train_epoch=np.asarray(result["train"]["epoch"]),
            train_loss=np.asarray(result["train"]["loss"]),
            val_epoch=np.asarray(result["valid"]["epoch"]),
            val_loss=np.asarray(result["valid"]["loss"]),
        )
        from .plotting import plot_loss_curves

        plot_loss_curves(result, path)

    def current_lr(self) -> float:
        """The learning rate the last step used."""
        return float(self.optimizer.schedule(max(self.optimizer.count - 1, 0)))

    @property
    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.model.parameters()))

    @property
    def num_bytes(self) -> int:
        return int(sum(p.numel() * p.element_size() for p in self.model.parameters()))


class StaticTrainer3D(TrainerBase):
    """Static (time-independent) 3D PDE trainer."""

    def __init__(self, config: RunConfig):
        strategy = config.dataset.training_strategy
        if strategy == "neural_field":
            # edges are built on the device from the sampled coordinates
            # (the reference's constraint, stat.py:48-54)
            if config.dataset.update_pt_files_with_edges:
                raise ValueError(
                    "neural_field training strategy requires update_pt_files_with_edges=False")
            if config.model.args.magno.asynchronous_graph_building:
                # the loader would build full-graph slots for every sample
                # that the neural-field step never reads
                raise ValueError(
                    "neural_field training strategy requires "
                    "asynchronous_graph_building=False (edges are built "
                    "on device from the sampled coordinates)")
            config.model.args.magno.precompute_edges = False
        # any other strategy trains on the full grid, as in the JAX trainer
        super().__init__(config)
        self.neural_field = None
        if strategy == "neural_field":
            ds = self.dataset_config
            self.neural_field = NeuralField(int(ds.neural_field_input_nodes),
                                            int(ds.neural_field_query_nodes_train),
                                            self.sample_generator)

    # -- data ---------------------------------------------------------------
    def init_dataset(self, dataset_config: DatasetConfig):
        logger.info("Initializing dataset ...")
        magno_cfg = self.model_config.args.magno
        if dataset_config.update_pt_files_with_edges:
            slot_mode = "precomputed"
        elif magno_cfg.asynchronous_graph_building:
            slot_mode = "async"
        else:
            slot_mode = "device"  # the model builds its slots in every forward
        self.slot_mode = slot_mode
        layout = parse_edge_layout(magno_cfg.edge_layout)
        if "sectioned" in layout:
            # degree sections need host-built (compacted) slots; the node
            # permutation happens at batch assembly (data/pipeline.py)
            if slot_mode == "device":
                raise ValueError("magno.edge_layout='sectioned' requires precomputed or "
                                 "async graph building")
            if not magno_cfg.slot_budget:
                raise ValueError("magno.edge_layout='sectioned' requires slot_budget (sections "
                                 "truncate the valid-first compacted K columns)")
        # node sharding needs SHARD-ALIGNED sections: the loader deals the
        # degree-sorted nodes round-robin to node_shards equal ranges and lays
        # every section out shard-major, so each rank's rows are one range
        self.section_shards = 1
        if "sectioned" in layout and self.shard_nodes:
            self.section_shards = self.mesh.node
            if dataset_config.pad_multiple % self.section_shards != 0:
                raise ValueError(
                    "sectioned + node sharding needs dataset.pad_multiple "
                    f"({dataset_config.pad_multiple}) divisible by "
                    f"node_shards ({self.section_shards})")
        if "flat" in layout and slot_mode == "device":
            raise ValueError("magno.edge_layout='flat' requires precomputed or async graph "
                             "building (update_pt_files_with_edges or "
                             "asynchronous_graph_building)")

        t0 = time.time()
        if dataset_config.metaname.startswith("synthetic/") and not os.path.isdir(
                os.path.join(dataset_config.base_path, dataset_config.processed_folder)):
            logger.info("Generating synthetic dataset at %s", dataset_config.base_path)
            generate_synthetic_dataset(dataset_config, dataset_config.base_path)
        self.dataset_seconds = time.time() - t0
        dims = self.model_config.args.latent_tokens
        lo, hi = self.metadata.domain_x
        # the latent grid spans the metadata domain rescaled to [-1, 1]; both
        # rescale modes use the scalar global min and max, so one map serves
        self.grid = LatentGrid.from_domain(dims, lo, hi, rescale_to=(-1, 1))

        train_ds = MeshDataset(dataset_config, "train") if self.setup_config.train else None
        if dataset_config.use_metadata_stats:
            self.stats = {"mean": np.asarray(self.metadata.global_mean, np.float32),
                          "std": np.asarray(self.metadata.global_std, np.float32)}
            # metadata constants are full-width: select the active channels
            if dataset_config.active_variables is not None:
                av = list(dataset_config.active_variables)
                self.stats = {k: v[av] for k, v in self.stats.items()}
        else:
            # computed stats are already in active-variable space
            self.stats = compute_or_load_stats(dataset_config, train_ds)

        pre = SamplePreprocessor(
            stats=self.stats, metadata=self.metadata,
            use_rescale_new=dataset_config.use_rescale_new,
            encoder_feature_attr=magno_cfg.encoder_feature_attr)
        self.preprocessor = pre

        enc_s, dec_s = parse_neighbor_strategy(magno_cfg.neighbor_strategy)
        build_slots = None
        t0 = time.time()
        if slot_mode == "precomputed":
            from ..data.graph_precompute import update_sample_files_with_edges

            # rank 0 sweeps (concurrent sweeps would race on the sample
            # files); the other ranks wait for it
            if self.is_main:
                update_sample_files_with_edges(dataset_config, magno_cfg, self.grid,
                                               self.metadata)
            self._barrier()
        elif slot_mode == "async":
            grid = self.grid
            # sections need valid-first budget-compacted slots from the host;
            # the other layouts keep the stencil window and the model compacts
            bud = (magno_cfg.slot_budget or 0) if "sectioned" in layout else 0

            def build_slots(pos):
                out = {"encoder": [], "decoder": []}
                for scale in magno_cfg.scales:
                    r = magno_cfg.gno_radius * scale
                    for side, strategy in (("encoder", enc_s), ("decoder", dec_s)):
                        out[side].append(build_edge_slots_host(
                            pos, grid, r, magno_cfg.k_neighbors, strategy, budget=bud))
                return out
        self.precompute_seconds = time.time() - t0
        magno_cfg.precompute_edges = slot_mode != "device"

        # one test dataset and preprocessed probe sample, shared by the budget
        # check, the loaders and the datarow's edge counts
        test_ds = MeshDataset(dataset_config, "test")
        probe_sample = pre(test_ds[0])
        if (dataset_config.use_metadata_stats and "c" in probe_sample
                and "c_mean" not in self.stats):
            logger.warning(
                "use_metadata_stats=True: dataset has condition features 'c' "
                "but metadata provides no c stats — 'c' is NOT normalized")

        # compaction is exact only when the budget covers the max degree:
        # check a real sample up front; the masks also give the edge counts
        probe_masks = {}
        for strat in {enc_s, dec_s}:
            for scale in magno_cfg.scales:
                _, m = build_edge_slots_host(probe_sample["pos"], self.grid,
                                             magno_cfg.gno_radius * scale,
                                             magno_cfg.k_neighbors, strat)
                probe_masks[(strat, scale)] = m
                deg = int(m.sum(axis=-1).max())
                if magno_cfg.slot_budget is not None and deg > magno_cfg.slot_budget:
                    raise ValueError(
                        f"magno.slot_budget={magno_cfg.slot_budget} is below the "
                        f"max per-point degree {deg} observed for strategy "
                        f"'{strat}' at scale {scale} — compaction would drop "
                        f"edges. Raise slot_budget to at least {deg}.")

        common = dict(
            preprocessor=pre,
            batch_size=dataset_config.batch_size,
            pad_multiple=dataset_config.pad_multiple,
            num_workers=dataset_config.num_workers,
            slot_mode=slot_mode,
            build_slots=build_slots,
            num_scales=len(magno_cfg.scales),
            edge_layout=magno_cfg.edge_layout,
            edge_chunk_size=magno_cfg.edge_chunk_size,
            flat_order=magno_cfg.flat_order,
            flat_edges_per_chunk=magno_cfg.flat_edges_per_chunk or 0,
            sectioned_profile=magno_cfg.sectioned_profile,
            section_shards=self.section_shards,
        )
        dc = bool(dataset_config.device_cache)
        # train and val are sharded by data rank (the DistributedSampler
        # analogue): the node ranks of one data index load the same samples
        data = 1 if self.mesh is None else self.mesh.data
        shard_kw = dict(num_shards=data, shard_index=0 if self.mesh is None
                        else self.mesh.data_rank)
        if self.setup_config.train:
            self.train_loader = BatchLoader(
                train_ds, shuffle=dataset_config.shuffle, seed=self.setup_config.seed,
                drop_last=data > 1, device_cache=dc, cache_put=self.put_batch, **shard_kw,
                **common)
            self.val_loader = BatchLoader(
                MeshDataset(dataset_config, "val"), shuffle=False, device_cache=dc,
                cache_put=self.put_batch, **shard_kw, **common)
        else:
            self.train_loader = None
            self.val_loader = None
        # no device cache for the test loader: test() runs once and its timing
        # report measures the real load and upload. It is not sharded: every
        # rank runs the whole set
        self.test_loader = BatchLoader(test_ds, shuffle=False, **common)
        self.num_input_channels = probe_sample["enc_feats"].shape[-1]
        self.num_output_channels = probe_sample["x"].shape[-1]

        # edge-count columns of the results row, measured on test sample 0
        self.datarow["p2r edges"] = int(probe_masks[(enc_s, magno_cfg.scales[0])].sum())
        self.datarow["r2p edges"] = int(probe_masks[(dec_s, magno_cfg.scales[0])].sum())
        self.datarow["r2r edges"] = -1  # no latent-latent graph (attention)

    # -- model ----------------------------------------------------------------
    def init_model(self, model_config):
        # setup.dtype 'bfloat16' turns the GNO kernel MLPs bf16 unless the
        # config pinned kernel_dtype already (gaot3d_tpu/train/trainer.py)
        if self.setup_config.dtype == "bfloat16":
            magno_cfg = model_config.args.magno
            if magno_cfg.kernel_dtype == "float32":
                magno_cfg.kernel_dtype = "bfloat16"
        self.model = init_model(
            input_size=self.num_input_channels,
            output_size=self.num_output_channels,
            model=model_config.name,
            magno_config=model_config.args.magno,
            attn_config=model_config.args.transformer,
            latent_tokens=model_config.args.latent_tokens,
            grid=self.grid,
            generator=self.init_generator,
            device=self.device,
        )

    # -- steps ------------------------------------------------------------------
    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.world_group is not None:
            torch.distributed.barrier()

    def _placement(self, batch: TrainBatch, replicate_data: bool = False):
        """The placement of this rank's rows of a sharded step (None
        undistributed): a sharded loader's batch sits at data_rank times its
        size; a batch every data rank holds whole is node-sharded alone."""
        if self.mesh is None:
            return None
        if replicate_data:
            return Placement(self.mesh.replicated_data(), 0)
        return Placement(self.mesh, self.mesh.data_rank * batch.pos.shape[0])

    def put_batch(self, batch, replicate_data: bool = False) -> TrainBatch:
        """This rank's rows of a host PointBatch as a TrainBatch on the
        trainer's device, through pinned memory on a card; a TrainBatch (a
        cached one) passes through. Distributed, the batch is cut to the
        rank's node shard (`shard_point_batch`): its rows are the data
        rank's already (the sharded loaders) or, with `replicate_data`, the
        whole batch (the test loader)."""
        if isinstance(batch, TrainBatch):
            return batch
        if self.mesh is not None:
            mesh = self.mesh.replicated_data() if replicate_data else self.mesh
            batch, _ = shard_point_batch(batch, mesh, self.shard_nodes, process_local=True)
        memo: dict = {}
        put = lambda a: pinned_to_device(a, self.device, memo)  # noqa: E731
        edges = [None, None]  # slot mode 'device': the model builds them
        if batch.enc_slots is not None:
            # one structure for one scale, a list of them for several
            edges = [[_edges_to_device(s, self.device, memo) for s in side]
                     for side in (batch.enc_slots, batch.dec_slots)]
            edges = [e[0] if len(e) == 1 else e for e in edges]
        return TrainBatch(
            pos=put(batch.pos), feats=put(batch.feats), target=put(batch.target),
            node_mask=put(batch.node_mask), enc_slots=edges[0], dec_slots=edges[1])

    def train_step(self, batch) -> torch.Tensor:
        batch = self.put_batch(batch)
        loss, self._last_grad_norm = self._train_step(self.model, self.optimizer, batch,
                                                      self.generator, self.neural_field)
        return loss

    def eval_step(self, batch, replicate_data: bool = False):
        """(this rank's prediction rows, the global masked MSE); with
        `replicate_data`, a batch every data rank holds whole (test())."""
        batch = self.put_batch(batch, replicate_data)
        with placed(self._placement(batch, replicate_data)):
            return eval_step(self.model, batch)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loops -----------------------------------------------------------------
    def optimize(self) -> Dict:
        """Epoch loop with eval cadence and best-state tracking."""
        args = self.optimizer_config.args
        best_loss, best_epoch, best_params = np.inf, -1, None
        losses, epochs, val_losses, val_epochs = [], [], [], []
        time_total = 0.0
        setup = self.setup_config
        for epoch in range(args.epoch):
            self.train_loader.set_epoch(epoch)
            profiler = None
            if setup.profile_dir and epoch == setup.profile_epoch:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
                # every thread, so the loader's prefetch thread lays its spans
                # too, where this torch's private profiler config offers it;
                # else the step loop's thread alone
                try:
                    from torch._C._profiler import _ExperimentalConfig
                    threads = {"experimental_config": _ExperimentalConfig(
                        profile_all_threads=True)}
                except (ImportError, TypeError):
                    threads = {}
                profiler = profile(activities=activities, **threads)
            total_loss = torch.zeros((), device=self.device)
            nb = 0
            t0 = time.time()
            loader_stats: Dict = {}
            for batch in prefetch_to_device(iter(self.train_loader), self.put_batch,
                                            stats=loader_stats):
                if profiler is not None and nb == 0:
                    profiler.start()
                total_loss += self.train_step(batch)  # device scalar; read at epoch end
                nb += 1
                if profiler is not None and nb == setup.profile_steps:
                    self._stop_profiler(profiler)
                    profiler = None
            if profiler is not None and nb > 0:  # fewer batches than profile_steps
                self._stop_profiler(profiler)
            total_loss = float(total_loss)  # waits for the epoch's last step
            epoch_wall = time.time() - t0
            time_total += epoch_wall
            # steady-state loader stall: queue waits past the warm-up batch;
            # about 0 means load and upload keep up with the step rate
            self.last_loader_stall_s = max(
                loader_stats.get("wait_s", 0.0) - loader_stats.get("first_wait_s", 0.0), 0.0)
            self.last_loader_first_wait_s = loader_stats.get("first_wait_s", 0.0)
            self.last_loader_stats = dict(loader_stats, epoch_wall_s=epoch_wall, steps=nb)
            logger.info(
                "epoch %d loader: stall %.3fs (first wait %.3fs), host_load %.3fs, "
                "put %.3fs, epoch wall %.2fs", epoch, self.last_loader_stall_s,
                self.last_loader_first_wait_s, loader_stats.get("host_load_s", 0.0),
                loader_stats.get("put_s", 0.0), epoch_wall)

            if (epoch + 1) % args.eval_every_eps == 0:
                train_loss = total_loss / max(nb, 1)
                losses.append(train_loss)
                epochs.append(epoch)
                val_loss = self.validate(
                    self.test_loader if args.validate_on_test else self.val_loader)
                val_losses.append(val_loss)
                val_epochs.append(epoch)
                logger.info("epoch %d: train %.6f  val %.6f", epoch, train_loss, val_loss)
                row = {"train/loss": train_loss, "val/loss": val_loss,
                       "lr": self.current_lr(), "memory": _process_rss_gb(),
                       "train/loader_stall_s": self.last_loader_stall_s,
                       "train/loader_host_load_s": loader_stats.get("host_load_s", 0.0),
                       "train/loader_put_s": loader_stats.get("put_s", 0.0)}
                if setup.wandb_watch_model and self._last_grad_norm is not None:
                    row["train/grad_norm"] = float(self._last_grad_norm)
                self.log_metrics(row, step=epoch + 1)

                current = val_loss if args.early_save_metric == "val" else train_loss
                if current < best_loss:
                    best_loss, best_epoch = current, epoch
                    best_params = {k: v.detach().clone()
                                   for k, v in self.model.state_dict().items()}
                if args.save_every_epochs > 0 and (epoch + 1) % args.save_every_epochs == 0:
                    self.save_checkpoint_artifact(epoch + 1, train_loss, val_loss,
                                                  is_best=(best_epoch == epoch))
                    if setup.test_during_training:
                        self.test()

        if best_params is not None:
            self.model.load_state_dict(best_params)
        return {
            "train": {"loss": losses, "epoch": epochs},
            "valid": {"loss": val_losses, "epoch": val_epochs},
            "best": {"epoch": best_epoch, "loss": float(best_loss)},
            "time": time_total,
            # the last epoch's data-feed accounting
            "loader": {
                "stall_s": self.last_loader_stall_s,
                "first_wait_s": self.last_loader_first_wait_s,
                "host_load_s": self.last_loader_stats.get("host_load_s", 0.0),
                "put_s": self.last_loader_stats.get("put_s", 0.0),
            },
        }

    def _stop_profiler(self, profiler) -> None:
        self._sync()
        profiler.stop()
        out_dir = self.setup_config.profile_dir
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "train_steps.trace.json")
        profiler.export_chrome_trace(path)
        logger.info("Saved torch.profiler trace to %s", path)

    def validate(self, loader) -> float:
        """Sum of batch-mean losses over the dataset size (the reference's
        quirk, kept). The loss accumulates on the device and is read once.
        Over a loader sharded by data rank, each step's term is the sum of
        the data ranks' own batch means (`_rank_mean_term`), as the
        reference's DDP validate all-reduces them."""
        total = torch.zeros((), device=self.device)
        if self.mesh is not None and loader.num_shards > 1:
            for batch in prefetch_to_device(iter(loader), self.put_batch):
                total += self._rank_mean_term(batch)
        else:
            replicate = self.mesh is not None  # an unsharded loader: the whole batch
            for batch in prefetch_to_device(iter(loader),
                                            lambda b: self.put_batch(b, replicate)):
                total += self.eval_step(batch, replicate)[1]
        return float(total) / len(loader.dataset)

    def _rank_mean_term(self, batch) -> torch.Tensor:
        """One step of the sharded validate: this data rank's squared errors
        and valid count (summed over its node group), their quotient, summed
        over the data ranks (gaot3d_tpu/train/trainer.py
        `_validate_multiprocess`)."""
        batch = self.put_batch(batch)
        pred, _ = self.eval_step(batch)
        diff = (pred - batch.target) * batch.node_mask[..., None]
        parts = torch.stack([(diff * diff).sum(), batch.node_mask.sum().to(pred.dtype)
                             * pred.shape[-1]])
        if self.mesh.node_group is not None:
            torch.distributed.all_reduce(parts, group=self.mesh.node_group)
        term = parts[0] / parts[1].clamp_min(1.0)
        if self.mesh.data_group is not None:
            torch.distributed.all_reduce(term, group=self.mesh.data_group)
        return term

    def test(self) -> Dict[str, float]:
        """Timed inference and the metric suites."""
        metric_suite = self.dataset_config.metric_suite
        all_targets, all_preds = [], []
        inference_times, data_times = [], []
        total_samples = 0
        plot_coords = plot_gtr = plot_prd = None
        u_mean = self.stats["mean"]
        u_std = self.stats["std"]

        it = iter(self.test_loader)
        while True:
            t0 = time.time()
            try:
                batch_host = next(it)
            except StopIteration:
                break
            batch = self.put_batch(batch_host, replicate_data=True)
            self._sync()
            data_times.append(time.time() - t0)

            t1 = time.time()
            pred, _ = self.eval_step(batch, replicate_data=True)
            if self.shard_nodes:  # every rank gathers the sample's node shards
                pred = gather_rows(pred, self.mesh.replicated_data(), True)
            self._sync()
            inference_times.append(time.time() - t1)
            pred_np = pred.cpu().numpy()

            counts = batch_host.num_nodes
            total_samples += int((counts > 0).sum())
            # valid rows by MASK, not by an [:n] prefix: degree sections
            # permute a sample's nodes, and boolean selection is right for
            # every layout; metrics and plots do not depend on the row order
            # (pos is permuted with the values)
            for b in range(pred_np.shape[0]):
                if int(counts[b]) == 0:
                    continue
                m = batch_host.node_mask[b]
                p_den = pred_np[b][m] * u_std + u_mean
                t_den = batch_host.target[b][m] * u_std + u_mean
                all_preds.append(p_den)
                all_targets.append(t_den)
                if plot_coords is None:
                    plot_coords, plot_gtr, plot_prd = batch_host.pos[b][m], t_den, p_den

        results: Dict[str, float] = {}
        if not inference_times or not self.is_main:
            return results
        total_inf = sum(inference_times)
        total_data = sum(data_times)
        total_time = total_inf + total_data
        report = {
            "total_samples": total_samples,
            "total_inference_time_s": total_inf,
            "avg_inference_time_ms": 1000 * statistics.mean(inference_times),
            "median_inference_time_ms": 1000 * statistics.median(inference_times),
            "min_inference_time_ms": 1000 * min(inference_times),
            "max_inference_time_ms": 1000 * max(inference_times),
            "std_inference_time_ms": 1000
            * (statistics.stdev(inference_times) if len(inference_times) > 1 else 0.0),
            "avg_data_loading_time_ms": 1000 * statistics.mean(data_times),
            "inference_throughput_samples_per_s": total_samples / total_inf,
            "overall_throughput_samples_per_s": total_samples / total_time,
            "data_loading_ratio_pct": 100 * total_data / total_time,
            "inference_ratio_pct": 100 * total_inf / total_time,
        }
        for k, v in report.items():
            logger.info("  %s: %s", k, f"{v:.4f}" if isinstance(v, float) else v)
        results.update(report)
        self.datarow["inference time"] = report["avg_inference_time_ms"] / 1000.0

        if metric_suite == "drivaernet":
            gm, gs = self.metadata.global_mean, self.metadata.global_std
            if self.dataset_config.active_variables is not None:
                av = self.dataset_config.active_variables
                gm, gs = [gm[i] for i in av], [gs[i] for i in av]
            agg = compute_drivaernet_metric(all_targets, all_preds, gm, gs)
            logger.info("--- Final Metrics (Drivaernet Suite) ---")
            logger.info("MSE (x10^-2): %.4f", agg["MSE"] * 100)
            logger.info("MAE (x10^-1): %.4f", agg["MAE"] * 10)
            logger.info("RMSE: %.4f  MaxErr: %.4f", agg["RMSE"], agg["Max_Error"])
            logger.info("Rel L2 (%%): %.4f  Rel L1 (%%): %.4f", agg["Rel_L2"] * 100,
                        agg["Rel_L1"] * 100)
            results.update(agg)
            self.datarow["MSE (x10^-2)"] = agg["MSE"] * 100
            self.datarow["MAE (x10^-1)"] = agg["MAE"] * 10
        elif metric_suite == "general":
            m = compute_general_metrics(np.concatenate(all_targets, axis=0),
                                        np.concatenate(all_preds, axis=0))
            logger.info("--- Final Metrics (General Suite) ---")
            for k, v in m.items():
                logger.info("  %s: %.6f", k, v)
            results.update(m)
            self.datarow["MSE (x10^-2)"] = m["MSE"] * 100
            self.datarow["MAE (x10^-1)"] = m["MAE"] * 10
        elif metric_suite == "poseidon":
            val = compute_poseidon_metric(all_targets, all_preds, self.metadata.global_mean,
                                          self.metadata.global_std)
            logger.info("--- Final Metric (Poseidon Suite): %.6f ---", val)
            results["poseidon_rel_l1_median"] = val
            self.datarow["relative error (direct)"] = val

        # npz dump, and a 3D render of the first sample when matplotlib is there
        out_base = self.path_config.result_path.rsplit(".", 1)[0]
        os.makedirs(os.path.dirname(out_base) or ".", exist_ok=True)
        np.savez(out_base + ".npz", coord=plot_coords, gtr=plot_gtr, prd=plot_prd)
        from .plotting import plot_3d_comparison

        plot_3d_comparison(plot_coords, plot_gtr[:, 0], plot_prd[:, 0],
                           save_path=self.path_config.result_path,
                           variable_name=self.metadata.names["u"][0] or "u")
        return results


TRAINERS = {"static3d": StaticTrainer3D}


def init_trainer(config: RunConfig) -> TrainerBase:
    name = config.setup.trainer_name
    if name not in TRAINERS:
        raise ValueError(f"unknown trainer '{name}', supported: {list(TRAINERS)}")
    return TRAINERS[name](config)
