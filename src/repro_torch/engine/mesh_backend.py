"""MeshBackend: the batched backend with its population axis split over a
device mesh.

The double-sampling design (paper Algorithm 4) makes every generation an
embarrassingly parallel population x client-group workload: group g
trains individual g's sub-model, and the 2N fitness evaluations are
independent.  ``VmapBackend`` turns that structure into a constant
number of batched calls; this backend additionally splits the
*population axis* of the same group-major stacks over the devices of a
``launch.mesh.Mesh`` (``make_host_mesh`` over ``RunConfig.device`` by
default, any concrete mesh through ``mesh=``), so each device touches
only its slice of the population:

  * ``train_fill`` — the groups are padded to a multiple of the device
    count with weight-0 rows (key 0, the store's first shards), each
    device runs ``backends.fill_bucket_partial`` (local SGD and the
    Algorithm 3 partial sum) over its slice of every shape bucket, and
    one ``psum`` forms the new master on the engine's device; on
    the ``"kernel"`` route each device returns its uploads instead
    (``train_bucket_uploads``), they are gathered, and Algorithm 3 runs
    on K1 after the call (``fill_aggregate_stacked``), one launch per
    bucket, as ``VmapBackend``'s;
  * ``train_fedavg_population`` — the individuals are split over the
    devices; every device FedAvg-trains its slice on the participants'
    shards (``fedavg_population_bucket``);
  * ``eval_shared`` / ``eval_paired`` — the 2N keys (and paired
    parameters) are split; each device counts its keys' test errors
    over the replicated test stacks, and the counts are gathered.

The mesh is the JAX package's: one process drives every device, so the
collectives are plain tensor operations (``launch/mesh.py``) and the
strategy (numpy RNG, sampling, NSGA-II) runs once.  A mesh may name one
device more than once, which is how the tests run an 8-way mesh on the
CPU.  On a one-device mesh every collective is the identity: the fused
``train_fill`` runs ``VmapBackend``'s bodies in its order and equals its
result bit for bit.  On an N-way mesh the float32 partial sums are added
per device, then across devices, so masters agree within reduction-order
noise; keys, CommStats (accounted by the strategies) and the integer
error counts are exact.

Dispatches are counted where the JAX package's ``MeshBackend`` counts
them: fused, one per ``train_fill`` and per evaluation (torch route); on
the kernel route one ``train_uploads`` call per shape bucket, whether
fused or not (the JAX package tests the route first), plus one K1 launch
per bucket; non-fused, one call per shape bucket.  Each of those
callables is ``obs.traced`` under the JAX package's program name.

Codecs (``CodecBackend``), telemetry (``InstrumentedBackend``) and
``ClientSimConfig`` dropout wrap or ride this backend unchanged: a
dropped client keeps its row at weight 0 and its error count is masked
by the ``alive`` vector, so the shapes and the dispatch count do not
change with dropout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.aggregate import fill_aggregate_stacked
from repro_torch.core.supernet import SupernetAPI
from repro_torch.data.pipeline import ClientDataset
from repro_torch.engine.backends import StackedClientBase, _tree_add, \
    accumulate_parts, cast_like, clients_in_turn, \
    eval_bucket_counts, eval_paired_bucket_counts, \
    fedavg_population_bucket, fill_bucket_partial, master_donation_safe, \
    train_bucket_uploads
from repro_torch.core.federated import client_update_fn, eval_count_fn
from repro_torch.engine.types import RunConfig
from repro_torch.launch.mesh import Mesh, all_gather, data_axes, \
    make_host_mesh, mesh_axis_size, psum, replicate
from repro_torch.obs import traced


class MeshBackend(StackedClientBase):
    """Population-axis-split execution over a device mesh.

    Args (beyond the backend constructor contract):
      * ``mesh`` — a concrete ``launch.mesh.Mesh``; by default
        ``make_host_mesh`` over ``cfg.device``: every visible card for
        ``"cuda"``, one CPU device for ``"cpu"``.  The population axis is
        split over ``launch.mesh.data_axes(mesh)``; the ``model`` axis
        replicates.  Every device of the mesh must be of
        ``cfg.device``'s type; an abstract mesh
        (``make_production_mesh``) raises ``ValueError``."""

    name = "mesh"

    def __init__(self, api: SupernetAPI, clients: Sequence[ClientDataset],
                 cfg: RunConfig, mesh: Optional[Mesh] = None):
        super().__init__(api, clients, cfg)
        if mesh is None:
            mesh = make_host_mesh(None if self.device.type == "cuda"
                                  else [self.device])
        if mesh.abstract:
            raise ValueError(f"MeshBackend needs a mesh of devices, not the "
                             f"abstract {mesh}")
        self.mesh = mesh
        self.axes = data_axes(mesh)
        self.num_devices = mesh_axis_size(mesh, self.axes)
        self.shard_devices = mesh.axis_devices(self.axes)
        if any(d.type != self.device.type for d in self.shard_devices):
            raise ValueError(f"{mesh} does not match RunConfig.device="
                             f"{cfg.device!r}")
        self.update = client_update_fn(api, cfg.local_epochs, cfg.momentum,
                                       span=self._span)
        self.evaluate = eval_count_fn(api)
        self.donate_master = (cfg.fused and master_donation_safe(cfg)
                              and self.device.type == "cuda")
        self._own_master = None      # the last master this backend made
        # each callable below is one dispatch, named as the JAX package's
        # jitted program it stands for; traced counts its input signatures
        tc = self.trace_counts
        self._fill_partial = traced("fill_partial", tc, self._fill_body)
        self._train_uploads = traced("train_uploads", tc,
                                     self._uploads_body)
        self._fedavg_partial = traced("fedavg_partial", tc,
                                      self._fedavg_body)
        self._eval_shared_counts = traced("eval_shared_counts", tc,
                                          self._eval_shared_body)
        self._eval_paired_counts = traced("eval_paired_counts", tc,
                                          self._eval_paired_body)
        self._fused_fill = traced("fused_fill", tc, self._fused_fill_body)
        self._fused_eval_shared = traced("fused_eval_shared", tc,
                                         self._eval_shared_body)
        self._fused_eval_paired = traced("fused_eval_paired", tc,
                                         self._eval_paired_body)
        self._fused_fedavg = traced("fused_fedavg", tc,
                                    self._fused_fedavg_body)

    def _train(self, master, key, xb, yb, lr):
        """One group's local SGD -> {name: (S, ...)} stacked uploads."""
        with self.telemetry.span("local_sgd"):
            return clients_in_turn(self.update, master, key, xb, yb, lr)

    # -- placement ------------------------------------------------------------

    def _pad(self, n: int) -> int:
        """Rows to append so the leading axis divides the mesh."""
        return (-n) % self.num_devices

    def _split(self, arr) -> list:
        """One stacked array (host numpy or a tensor), its leading
        population axis padded to a mesh multiple, split along that axis
        into one slice per device: tensors moved to their device, host
        arrays kept on the host."""
        step = arr.shape[0] // self.num_devices
        parts = [arr[i * step:(i + 1) * step]
                 for i in range(self.num_devices)]
        if isinstance(arr, torch.Tensor):
            return [p.to(d) for p, d in zip(parts, self.shard_devices)]
        return parts

    @staticmethod
    def _shards(shards, dev) -> list:
        """The test buckets ``(xb, yb, alive)`` on ``dev``: the cached
        stacks themselves on their own device (a mesh over several cards
        copies them to each per call), the host survivor masks put
        there."""
        return [(xb.to(dev), yb.to(dev), torch.as_tensor(alive, device=dev))
                for xb, yb, alive in shards]

    # -- program bodies (one dispatch each) -----------------------------------

    def _fill_parts(self, master, buckets, lr) -> list:
        """Each device's float32 Algorithm 3 partial sum over its slice
        of every bucket in ``buckets`` (keys, xb, yb, w: per-device
        lists), added onto one running sum per device in bucket order."""
        parts = []
        for i, dev in enumerate(self.shard_devices):
            m = replicate(master, dev)
            acc = None
            for keys, xb, yb, w in buckets:
                acc = fill_bucket_partial(
                    self._train, self.api.trained_mask, m, keys[i], xb[i],
                    yb[i], torch.as_tensor(w[i], device=dev), lr, acc,
                    span=self._span)
            parts.append(acc)
        return parts

    def _home(self, tree):
        """``tree`` on the engine's device, where the master lives (the
        mesh's first device need not be it)."""
        return replicate(tree, self.device)

    def _fill_body(self, master, keys, xb, yb, w, lr):
        """Non-fused fill of one bucket: the partials' ``psum``."""
        return self._home(psum(self._fill_parts(master,
                                                [(keys, xb, yb, w)], lr)))

    def _fused_fill_body(self, master, buckets, lr):
        """Fused fill on the torch route: every bucket's local SGD and
        Algorithm 3 partial sums, one ``psum``, cast back to the master's
        dtypes — into the master's own tensors when donation is on and
        this backend made that master."""
        acc = self._home(psum(self._fill_parts(master, buckets, lr)))
        donate = self.donate_master and master is self._own_master
        return cast_like(acc, master, donate=donate)

    def _uploads_body(self, master, keys, xb, yb, lr):
        """Kernel route, one bucket: each device's local SGD of its slice,
        the uploads gathered group-major on the engine's device."""
        return self._home(all_gather([
            train_bucket_uploads(self._train, replicate(master, dev), k, x,
                                 y, lr)
            for dev, k, x, y in zip(self.shard_devices, keys, xb, yb)]))

    def _fedavg_parts(self, ps, keys, buckets, lr) -> List[list]:
        """Each device's per-individual FedAvg partial sums over every
        bucket, for its slice of the individuals (``ps``, ``keys``:
        per-device lists)."""
        parts = []
        for i, dev in enumerate(self.shard_devices):
            mine = [replicate(p, dev) for p in ps[i]]
            parts.append(accumulate_parts(
                fedavg_population_bucket(self._train, mine, keys[i],
                                         xb.to(dev), yb.to(dev),
                                         torch.as_tensor(wn, device=dev), lr)
                for xb, yb, wn in buckets))
        return parts

    def _gather_models(self, parts: List[list]) -> list:
        """Per-device lists of models, concatenated on the engine's
        device."""
        return [self._home(p) for part in parts for p in part]

    def _fedavg_body(self, ps, keys, xb, yb, wn, lr):
        """Non-fused FedAvg partials of every individual over one bucket."""
        return self._gather_models(self._fedavg_parts(ps, keys,
                                                      [(xb, yb, wn)], lr))

    def _fused_fedavg_body(self, ps, keys, buckets, lr):
        """Fused FedAvg of every individual over every bucket, each cast
        back to its individual's dtypes."""
        parts = self._fedavg_parts(ps, keys, buckets, lr)
        return self._gather_models(
            [[cast_like(o, p) for o, p in zip(part, mine)]
             for part, mine in zip(parts, ps)])

    def _eval_shared_body(self, params, keys, shards):
        """Wrong counts of each device's keys on the shared master over
        every test bucket in ``shards``, gathered on the first device."""
        return all_gather([
            accumulate_parts(eval_bucket_counts(
                self.evaluate, replicate(params, dev), k, xb, yb, alive,
                tile=self.cfg.vmap_eval_tile)
                for xb, yb, alive in self._shards(shards, dev))
            for dev, k in zip(self.shard_devices, keys)])

    def _eval_paired_body(self, ps, keys, shards):
        """``_eval_shared_body`` for (params, key) pairs split together."""
        return all_gather([
            accumulate_parts(eval_paired_bucket_counts(
                self.evaluate, [replicate(p, dev) for p in mine], k, xb, yb,
                alive, tile=self.cfg.vmap_eval_tile)
                for xb, yb, alive in self._shards(shards, dev))
            for dev, mine, k in zip(self.shard_devices, ps, keys)])

    # -- train_fill -----------------------------------------------------------

    def _group_bucket_arrays(self, keys, groups, total, survivors=None,
                             store=None):
        """The base builder with the groups padded to a mesh multiple and
        every array split over the devices (weight-0 padding, which also
        carries the dropped clients)."""
        return super()._group_bucket_arrays(
            keys, groups, total, survivors=survivors, store=store,
            pad_groups=self._pad(len(groups)), place=self._split)

    def train_fill(self, master, keys, groups, lr, survivors=None):
        groups = [np.asarray(g) for g in groups]
        total = self._survivor_total([c for g in groups for c in g],
                                     survivors)
        if total == 0.0:
            return master
        buckets = self._group_bucket_arrays(keys, groups, total,
                                            survivors=survivors)
        if not buckets:
            return master
        if self.cfg.aggregate_backend == "kernel":
            return self._train_fill_kernel(master, buckets, lr)
        if self.cfg.fused:
            # one dispatch for the whole generation's fill-train
            self._own_master = self._fused_fill(master, buckets, lr)
            self.dispatches += 1
            return self._own_master
        acc = None
        for bucket in buckets:
            part = self._fill_partial(master, *bucket, lr)
            self.dispatches += 1
            acc = part if acc is None else _tree_add(acc, part)
        return cast_like(acc, master)

    def _train_fill_kernel(self, master, buckets, lr):
        """Kernel route: one ``train_uploads`` call per bucket, then
        Algorithm 3 on K1 through ``fill_aggregate_stacked`` with the
        weights already normalized (weight-0 padding rows contribute
        nothing), one launch per bucket, the last in place."""
        chunks = []
        for keys, xb, yb, w in buckets:
            outs = self._train_uploads(master, keys, xb, yb, lr)
            self.dispatches += 1
            w = np.concatenate(w)
            chunks.append((outs, np.repeat(np.concatenate(keys), w.shape[1],
                                           axis=0), w.reshape(-1)))
        with self.telemetry.span("fill_aggregate"):
            master = fill_aggregate_stacked(master, chunks,
                                            mask_fn=self.api.trained_mask,
                                            backend="kernel", total=1.0)
        self.dispatches += len(chunks)
        return master

    # -- FedAvg paths (train_fedavg delegates via StackedClientBase) ---------

    def _padded(self, items: list) -> list:
        """``items`` padded with copies of its last entry to a mesh
        multiple, split into one list per device."""
        items = list(items) + [items[-1]] * self._pad(len(items))
        step = len(items) // self.num_devices
        return [items[i * step:(i + 1) * step]
                for i in range(self.num_devices)]

    def _split_keys(self, keys) -> list:
        return self._padded([np.asarray(k, np.int32) for k in keys])

    def train_fedavg_population(self, params_list, keys, client_ids, lr,
                                survivors=None):
        if not params_list:
            return []
        total = self._survivor_total(client_ids, survivors)
        if total == 0.0:               # nobody survived: models untouched
            return list(params_list)
        n = len(params_list)
        ps = self._padded(params_list)
        ks = self._split_keys(keys)
        batches = [(xb, yb, w / total) for xb, yb, w, _ in
                   self._group_train_gather(client_ids, survivors)]
        if self.cfg.fused:
            out = self._fused_fedavg(ps, ks, batches, lr)
            self.dispatches += 1
            return out[:n]
        acc = None
        for xb, yb, wn in batches:
            part = self._fedavg_partial(ps, ks, xb, yb, wn, lr)
            self.dispatches += 1
            acc = part if acc is None else _tree_add(acc, part)
        return [cast_like(a, p) for a, p in zip(acc[:n], params_list)]

    # -- evaluation -----------------------------------------------------------

    def _eval(self, fused, per_bucket, models, keys, client_ids, survivors):
        """Shared body of both evaluations (``models``: the shared master,
        or the parameter trees split as the keys are): the survivor
        masks, then one fused call over every bucket or one call per
        bucket."""
        batches = self._test_batches(client_ids)
        masks = self._alive_masks(batches, survivors)
        total = self._alive_total(batches, masks)
        if total == 0:                 # nobody evaluated: pessimistic
            return np.ones(len(keys))
        ks = self._split_keys(keys)
        shards = [(cb.xb, cb.yb, m) for cb, m in zip(batches, masks)]
        if self.cfg.fused:
            counts = fused(models, ks, shards)
            self.dispatches += 1
            return self._rates(counts, total, len(keys))
        wrong = np.zeros(sum(len(k) for k in ks), np.int64)
        for shard in shards:
            counts = per_bucket(models, ks, [shard])
            self.dispatches += 1
            wrong += counts.cpu().numpy().astype(np.int64)
        return wrong[:len(keys)] / total

    def eval_shared(self, params, keys, client_ids, survivors=None):
        return self._eval(self._fused_eval_shared, self._eval_shared_counts,
                          params, keys, client_ids, survivors)

    def eval_paired(self, params_list, keys, client_ids, survivors=None):
        return self._eval(self._fused_eval_paired, self._eval_paired_counts,
                          self._padded(params_list), keys, client_ids,
                          survivors)
