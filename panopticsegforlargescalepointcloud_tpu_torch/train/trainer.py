"""Trainer: the orchestration layer (counterpart of the JAX package's
``train/trainer.py``).

Wires dataset -> train steps -> validation -> checkpoint:

* the epoch loop with the prepare -> full phase switch at ``prepare_epoch``
  (the full step with clustering and the ScoreNet, one per state of the
  mask head's epoch gates, as is the validation forward);
* per-epoch lr schedules, ReduceLROnPlateau on the monitored validation
  loss, gradient accumulation and the BN-momentum step decay;
* validation epochs with semantic and, from the full phase on, instance
  metrics;
* named-weight-set checkpoints with resume;
* synthetic planted-instance tiles when no dataset files are configured, so
  the whole loop runs anywhere.

Every draw of the tile stream comes from one ``np.random.Generator`` seeded
with ``training.seed`` (dataset construction, the example batch drawn at
construction, then each batch), or, with ``num_workers > 0``, batch i from
``default_rng([seed, i])``: the JAX package's order, so one seed gives both
packages the same tiles. The model is initialized from a
``torch.Generator`` seeded with ``training.seed``. Runs on ``cuda`` unless
``device="cpu"``; without a GPU it raises.

Data parallelism (``training.num_devices`` D > 1, ``batch_size`` per
device): the trainer runs in every rank of a :class:`..parallel.Mesh` of D
ranks (``mesh=``; the train CLI starts them). Each batch is D device
batches drawn from the one stream in device order, as the JAX trainer
draws them: every rank draws all D and keeps its own block. The steps are
:func:`..parallel.make_parallel_train_step`. Validation runs on rank 0's
replica alone, as the JAX trainer validates on a host copy of the
replicated weights; the other ranks draw the same validation tiles (the
stream stays aligned) and receive rank 0's metrics, so that the plateau
controller steps alike everywhere. Only rank 0 writes the checkpoint, the
run log and ``metrics.jsonl``; a resume loads on every rank and then
replicates rank 0's weights.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.schema import panoptic_config_from_yaml
from ..data import (
    PanopticFileDataset,
    batch_arrays,
    collate_tiles,
    stack_device_batches,
    synthetic_tile,
)
from ..device import resolve_device
from ..eval.confusion import ConfusionMatrix
from ..eval.extract import device_part, host_part, pull
from ..eval.instance_metrics import InstanceAPMeter, _Instance, compute_acc, compute_eval
from ..eval.visualizer import Visualizer
from ..models.pointgroup3heads import PointGroup3HeadsNet
from ..utils import trace
from ..utils.wandb_utils import WandbLogger
from .checkpoint import ModelCheckpoint
from .optim import apply_plateau_scale, build_from_config
from .step import TrainState, init_params, make_eval_forward, make_train_step

log = logging.getLogger(__name__)


class SyntheticTiles:
    """Fallback data source with the PanopticFileDataset sampling API."""

    def __init__(self, spec):
        self.spec = spec

    def sample_train_tile(self, rng):
        return synthetic_tile(
            rng,
            num_classes=self.spec.num_classes,
            stuff_classes=self.spec.stuff_classes,
        )


class Trainer:
    def __init__(
        self,
        cfg: Dict,
        capacity: int = 65536,
        backbone: str = "paper",
        checkpoint_dir: Optional[str] = None,
        device=None,
        mesh=None,
        **budget_overrides,
    ):
        """``mesh``: this rank's :class:`..parallel.Mesh` when
        ``training.num_devices`` asks for more than one device (its device
        replaces ``device``)."""
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.cfg = cfg
        self.pcfg, self.spec, self.tcfg = panoptic_config_from_yaml(
            cfg, backbone=backbone, **budget_overrides
        )
        self.capacity = capacity
        # the run config in checkpoints rebuilds the same model: the
        # constructor's knobs (backbone, capacity, budget overrides) are
        # recorded beside the yaml tree
        self._run_config = dict(cfg)
        self._run_config["backbone"] = backbone
        self._run_config["budget_overrides"] = dict(budget_overrides)
        data_rc = dict(self._run_config.get("data", {}) or {})
        data_rc.setdefault("voxel_capacity", capacity)
        self._run_config["data"] = data_rc
        self.rng = np.random.default_rng(self.tcfg.seed)

        data_cfg = cfg.get("data", {})
        files = data_cfg.get("files", {}) or {}
        # the data yaml's transform lists; None -> the paper stacks
        ds_kwargs = dict(
            grid_size=float(data_cfg.get("grid_size", 0.2)),
            radius=float(data_cfg.get("radius", 8)),
            processed_dir=data_cfg.get("processed_dir"),
            sampling_format=str(data_cfg.get("sampling_format", "cylinder")),
            train_transforms=data_cfg.get("train_transforms"),
            test_transforms=(data_cfg.get("val_transform")
                             or data_cfg.get("test_transform")
                             or data_cfg.get("test_transforms")),
            pre_collate_transform=data_cfg.get("pre_collate_transform"),
            rng=self.rng,
        )
        if files.get("train"):
            self.dataset = PanopticFileDataset(self.spec, files["train"], **ds_kwargs)
            self.val_dataset = (
                PanopticFileDataset(self.spec, files["val"], **ds_kwargs)
                if files.get("val")
                else self.dataset
            )
        else:
            log.warning("no dataset files configured - using synthetic tiles")
            self.dataset = SyntheticTiles(self.spec)
            self.val_dataset = self.dataset

        # data parallelism: batch_size is per device
        nd = self.tcfg.num_devices
        if nd == 0:  # every visible device
            nd = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if nd > 1 and mesh is None:
            raise ValueError(f"training.num_devices={nd}: run the trainer in each rank of a "
                             f"mesh of {nd} ranks (cli.train starts them)")
        if mesh is not None and mesh.size != max(nd, 1):
            raise ValueError(f"training.num_devices={nd} on a mesh of {mesh.size} ranks")
        self.num_devices = max(nd, 1)
        self.is_root = mesh is None or mesh.is_root
        global_batch = self.tcfg.batch_size * self.num_devices
        self.steps_per_epoch = max(self.tcfg.samples_per_epoch // global_batch, 1)
        self.model = init_params(PointGroup3HeadsNet(self.pcfg),
                                 torch.Generator().manual_seed(self.tcfg.seed)).to(self.device)
        self.optimizer, self.lr_schedule, self.plateau = build_from_config(
            self.tcfg, self.steps_per_epoch, self.model.parameters())
        self.state = TrainState(self.model, self.optimizer, self.tcfg.bn_momentum)

        cw = None
        if self.tcfg.use_class_weights and hasattr(self.dataset, "class_weights"):
            cw = self.dataset.class_weights()
            log.info("weighted semantic NLL, class weights %s", np.round(cw, 3))
        self._step_kwargs = dict(grad_clip_value=self.tcfg.grad_clip_value, class_weights=cw,
                                 grad_accum=self.tcfg.grad_accum)
        self._prepare_step = self._make_step(False)
        # full steps and validation forwards by the mask head's gate state
        # (at most four a run)
        self._full_steps: Dict[tuple, object] = {}
        self._eval_fwds: Dict[tuple, object] = {}
        self._eval_fwd_basic = make_eval_forward(self.pcfg, self.model, device=self.device,
                                                 with_clustering=False)
        # the JAX package draws an example batch here to initialize its
        # model; the draw is kept so that every later tile is the same
        self._collate_one_device()

        wandb_cfg = cfg.get("training", {}).get("wandb", {}) or {}
        tb_cfg = cfg.get("training", {}).get("tensorboard", {}) or {}
        self.logger = WandbLogger(
            enabled=bool(wandb_cfg.get("log", False)),
            project=str(wandb_cfg.get("project", "panoptic-tpu")),
            config=cfg,
            run_dir=checkpoint_dir or self.tcfg.checkpoint_dir or ".",
            tensorboard=bool(tb_cfg.get("log", False)),
        ) if self.is_root else None
        # seconds and count of the data waits and steps taken, read from
        # the recorder's ``data`` and ``step`` spans: ``time_data``, ``time_step``
        self._stage_s: Dict[str, List[float]] = {}
        viz_cfg = cfg.get("visualization", {}) or {}
        self.visualizer = (
            Visualizer(
                out_dir=str(viz_cfg.get("out_dir", "viz")),
                num_samples_per_epoch=int(viz_cfg.get("num_samples_per_epoch", 2)),
            )
            if viz_cfg.get("activate", False)
            else None
        )
        # asynchronous input pipeline; 0 workers = synchronous sampling
        self._prefetcher = None
        if self.tcfg.num_workers > 0:
            from ..data.prefetch import BatchPrefetcher

            self._prefetcher = BatchPrefetcher(
                self._make_batch,
                seed=self.tcfg.seed,
                num_workers=self.tcfg.num_workers,
                prefetch=max(2 * self.tcfg.num_workers, 4),
            )
        self.start_epoch = 1
        self.checkpoint = None
        if checkpoint_dir or self.tcfg.checkpoint_dir:
            self.checkpoint = ModelCheckpoint(
                checkpoint_dir or self.tcfg.checkpoint_dir,
                run_config=self._run_config,
            )
            if "latest" in self.checkpoint.weight_names:
                self._load_weights("latest")
                self.start_epoch = self.checkpoint.start_epoch
                log.info("resumed from epoch %d", self.start_epoch)
        if mesh is not None:
            from ..parallel import replicate

            replicate(mesh, self.model)

    def _load_weights(self, name: str):
        w = self.checkpoint.get_weights(name)
        self.model.load_state_dict(w["state_dict"], strict=True)
        opt = self.checkpoint.get_optimizer_state()
        if opt is not None:
            self.optimizer.load_state_dict(opt)
            # the step count restarts at the epoch boundary, as in the JAX
            # package; the schedule's count comes back with the state
            for group in self.optimizer.param_groups:
                group["calls"] = (self.checkpoint.start_epoch - 1) * self.steps_per_epoch

    def close(self) -> None:
        """Stop the input pipeline's threads."""
        if self._prefetcher is not None:
            self._prefetcher.close()

    def _make_step(self, with_clustering: bool, epoch: Optional[int] = None):
        if self.mesh is None:
            return make_train_step(self.pcfg, self.model, self.optimizer, self.lr_schedule,
                                   with_clustering, device=self.device, epoch=epoch,
                                   **self._step_kwargs)
        from ..parallel import make_parallel_train_step

        return make_parallel_train_step(self.pcfg, self.model, self.optimizer,
                                        self.lr_schedule, self.mesh, with_clustering,
                                        epoch=epoch, **self._step_kwargs)

    def _full_step_for(self, epoch: int):
        """The full step with the mask head's epoch gates as they stand at
        ``epoch`` (the reference flips them when the epoch passes their
        start epochs), built once per gate state."""
        key = self.pcfg.gates(epoch)
        if key not in self._full_steps:
            self._full_steps[key] = self._make_step(True, epoch)
        return self._full_steps[key]

    def _eval_fwd_for(self, epoch: int):
        """The validation forward with clustering, its gates as the train
        step's at ``epoch`` (keyed as :meth:`_full_step_for`)."""
        key = self.pcfg.gates(epoch)
        if key not in self._eval_fwds:
            self._eval_fwds[key] = make_eval_forward(self.pcfg, self.model, device=self.device,
                                                     epoch=epoch)
        return self._eval_fwds[key]

    # ------------------------------------------------------------------
    def _collate_one_device(self, rng=None):
        rng = rng if rng is not None else self.rng
        tiles = [self.dataset.sample_train_tile(rng) for _ in range(self.tcfg.batch_size)]
        return collate_tiles(tiles, capacity=self.capacity, num_tiles=self.tcfg.batch_size)

    def _make_batch(self, rng):
        """One step's batch: one device batch, or on a mesh the D device
        batches stacked on a leading axis, drawn in device order."""
        if self.mesh is None:
            return self._collate_one_device(rng)
        return stack_device_batches([self._collate_one_device(rng)
                                     for _ in range(self.num_devices)])

    def _next_batch(self):
        if self._prefetcher is not None:
            return next(self._prefetcher)
        return self._make_batch(self.rng)

    def train(self, epochs: Optional[int] = None, batches_per_epoch: Optional[int] = None):
        epochs = epochs or self.tcfg.epochs
        nb = batches_per_epoch or self.steps_per_epoch
        # debugging knobs: early_break stops after one batch; profiling caps
        # the batch count
        dbg = self.cfg.get("debugging", {}) or {}
        if dbg.get("early_break"):
            nb = 1
            epochs = min(epochs, self.start_epoch)
        elif dbg.get("profiling"):
            nb = min(nb, int(dbg.get("num_batches", 50)))
        for epoch in range(self.start_epoch, epochs + 1):
            t0 = time.time()
            # BN momentum step decay: clip(bn_momentum * bn_decay ** (epoch //
            # decay_step), bn_clip)
            self.state.bn_momentum = max(
                self.tcfg.bn_momentum
                * (self.tcfg.bn_decay ** (epoch // max(self.tcfg.bn_decay_every, 1))),
                self.tcfg.bn_clip,
            )
            metrics = self._train_epoch(epoch, nb)
            log.info("epoch %d done in %.1fs: %s", epoch, time.time() - t0,
                     {k: round(v, 4) for k, v in metrics.items()})
            stage_metrics = {"train": metrics}
            if self.visualizer is not None:
                self.visualizer.begin_epoch(epoch)
            if epoch % self.tcfg.eval_frequency == 0:
                val = self._validate(epoch, num_batches=max(nb // 10, 1))
                stage_metrics["val"] = val
                log.info("val: %s", {k: round(v, 4) for k, v in val.items()})
                if self.plateau is not None:
                    # ReduceLROnPlateau on the monitored validation loss
                    monitored = val.get("loss", val.get("semantic_loss"))
                    if monitored is not None:
                        apply_plateau_scale(self.optimizer, self.plateau.step(float(monitored)))
            if self.checkpoint and self.is_root:
                self.checkpoint.save_best_models_under_current_metrics(
                    {"state_dict": self.model.state_dict()}, self.optimizer.state_dict(),
                    stage_metrics)
        return self.state

    def _train_epoch(self, epoch: int, num_batches: int) -> Dict[str, float]:
        step = (self._full_step_for(epoch) if epoch > self.pcfg.prepare_epoch
                else self._prepare_step)
        agg: Dict[str, float] = {}
        find_nbr = bool((self.cfg.get("debugging", {}) or {}).get("find_neighbour_dist"))
        nbr_stats: Dict[str, float] = {}
        for bi in range(num_batches):
            with trace.span("data", alone=True) as data:
                vb = self._next_batch()
                if find_nbr and bi == 0:
                    # neighbour counts at the clustering radius on the first
                    # batch of the epoch (on a mesh, device 0's)
                    from ..utils.debugging import neighbour_count_stats

                    kn = self.pcfg.rg_k_neighbors
                    flat = vb if self.mesh is None else type(vb)(*[a[0] for a in vb])
                    stats = neighbour_count_stats(flat.pos, flat.batch, flat.mask,
                                                  self.pcfg.cluster_radius, kn,
                                                  device=self.device)
                    log.info("neighbour dist @ r=%.3g k=%d: %s", self.pcfg.cluster_radius, kn,
                             {k: round(v, 3) for k, v in stats.items()})
                    nbr_stats = stats
                arrays = batch_arrays(vb)
                if self.mesh is not None:
                    from ..parallel import shard_batch

                    arrays = shard_batch(self.mesh, arrays)
            with trace.span("step", alone=True) as stage:
                # reading the metrics as floats waits for the device: the
                # stage ends in a synchronize
                metrics = {k: float(v) for k, v in step(arrays, self.state.bn_momentum).items()}
            self._read_stages(data, stage)
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v
        out = {k: v / num_batches for k, v in agg.items()}
        out.update(nbr_stats)
        opt_steps = self.state.step // max(self.tcfg.grad_accum, 1)
        out["lr"] = float(self.lr_schedule(opt_steps))
        out.update({f"time_{k}": s / n for k, (s, n) in self._stage_s.items()})
        if self.logger is not None:
            self.logger.log({f"train_{k}": v for k, v in out.items()}, step=self.state.step)
        return out

    def _read_stages(self, *spans) -> None:
        """Take the ``data`` and ``step`` spans' records from the recorder
        into the running means; its other records stay for their readers."""
        for span in spans:
            r = trace.take(span)
            acc = self._stage_s.setdefault(r.name, [0.0, 0])
            acc[0] += (r.end_ns - r.start_ns) / 1e9
            acc[1] += 1

    def _validate(self, epoch: int, num_batches: int) -> Dict[str, float]:
        """:meth:`eval_epoch`; on a mesh on rank 0 alone, while the other
        ranks draw the same validation tiles, and its metrics on every
        rank."""
        if self.mesh is None:
            return self.eval_epoch(epoch, num_batches)
        from ..parallel.mesh import broadcast_object

        if self.mesh.is_root:
            val = self.eval_epoch(epoch, num_batches)
        else:
            for _ in self._val_batches(num_batches):
                pass
            val = None
        return broadcast_object(self.mesh, val)

    # ------------------------------------------------------------------
    def _val_batches(self, num_batches: int):
        """Yield validation VoxelBatches.

        With ``training.full_val`` and a file-backed val split, walks the
        whole split as a deterministic PCA-grid tiling, so the
        ``best_<metric>`` checkpoint selection is stable and reproducible.
        Otherwise samples ``num_batches`` random val-style tiles.
        """
        if self.tcfg.full_val and hasattr(self.val_dataset, "test_tiles"):
            tiles = []
            for fi in range(len(self.val_dataset.files)):
                tiles.extend(t for t, _ in self.val_dataset.test_tiles(fi))
            for i in range(0, len(tiles), self.tcfg.batch_size):
                yield collate_tiles(tiles[i:i + self.tcfg.batch_size], capacity=self.capacity,
                                    num_tiles=self.tcfg.batch_size)
            return
        for _ in range(num_batches):
            tiles = [self.val_dataset.sample_train_tile(self.rng)
                     for _ in range(self.tcfg.batch_size)]
            yield collate_tiles(tiles, capacity=self.capacity, num_tiles=self.tcfg.batch_size)

    def eval_epoch(self, epoch: int, num_batches: int = 10,
                   with_instances: Optional[bool] = None) -> Dict[str, float]:
        if with_instances is None:
            with_instances = epoch > self.pcfg.prepare_epoch
        fwd = self._eval_fwd_for(epoch) if with_instances else self._eval_fwd_basic
        cm = ConfusionMatrix(self.pcfg.num_classes)
        inst_metrics: List[tuple] = []
        ap_meter = InstanceAPMeter()
        scan_offset = 0
        for bi, vb in enumerate(self._val_batches(num_batches)):
            # the embed family's subsets: a counter per (epoch, batch)
            db, out = fwd(batch_arrays(vb), subset_seed=epoch * 100003 + bi)
            fetch = {"mask": db.grid.mask, "y": db.y, "pred": out.semantic_logits.argmax(-1),
                     "inst": db.instance_labels, "batch": db.grid.batch}
            if self.visualizer is not None:
                fetch.update(pos=db.pos, offsets=out.offset_logits, embeds=out.embed_logits)
            if with_instances:
                dev = device_part(out.proposals, out.cluster_scores, db.grid.capacity)
                fetch.update({"p_" + k: v for k, v in dev.items()})
            h = pull(fetch)  # one device-to-host copy per batch
            mask, y, pred = h["mask"], h["y"], h["pred"]
            ok = mask & (y >= 0)
            cm.count_predicted_batch(y[ok], pred[ok])
            if self.visualizer is not None:
                self.visualizer.maybe_save(h["pos"], mask, y, pred, instance_labels=h["inst"],
                                           offsets=h["offsets"], embeds=h["embeds"])
            if not with_instances:
                continue
            props = {k[2:]: v for k, v in h.items() if k.startswith("p_")}
            scores = props.get("scores")
            clusters, kept_ids = host_part(props, None,
                                           nms_threshold=self.pcfg.nms_threshold,
                                           min_cluster_points=self.pcfg.min_cluster_points,
                                           min_score=self.pcfg.min_score)
            if not clusters:
                continue
            inst, batch = h["inst"], h["batch"]
            ninst = int((np.unique(inst * (batch >= 0))).max())
            acc = compute_acc(clusters, pred, inst, y, batch, max(ninst, 1))
            ev = compute_eval(clusters, pred, inst, y, batch, self.pcfg.num_classes,
                              self.spec.thing_classes)
            inst_metrics.append(acc + ev)
            # VOC AP over the accumulated scans (the tracker's 'map' metric)
            preds_i = [
                _Instance(
                    classname=int(np.bincount(pred[c]).argmax()),
                    score=float(scores[k]) if scores is not None else -1.0,
                    indices=c,
                    scan_id=int(batch[c[0]]) + scan_offset,
                )
                for c, k in zip(clusters, kept_ids)
            ]
            gts_i = []
            for s_id in np.unique(batch[batch >= 0]):
                smask = batch == s_id
                for g in np.unique(inst[smask]):
                    if g <= 0:
                        continue
                    idxs = np.where((inst == g) & smask)[0]
                    gts_i.append(_Instance(
                        classname=int(np.bincount(np.maximum(y[idxs], 0)).argmax()),
                        score=-1.0,
                        indices=idxs,
                        scan_id=int(s_id) + scan_offset,
                    ))
            ap_meter.add(preds_i, gts_i)
            scan_offset += int(batch.max()) + 1
        out_metrics = {
            "miou": cm.get_average_intersection_union(),
            "acc": cm.get_overall_accuracy(),
            "macc": cm.get_mean_class_accuracy(),
        }
        if inst_metrics:
            arr = np.asarray(inst_metrics)
            for i, k in enumerate(["pos", "neg", "Iacc", "cov", "wcov", "mIPre", "mIRec", "F1"]):
                out_metrics[k] = float(arr[:, i].mean())
            _, _, aps = ap_meter.eval(0.5)
            if aps:
                out_metrics["map"] = float(np.mean(list(aps.values())))
        return out_metrics
