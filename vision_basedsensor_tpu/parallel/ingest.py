"""Sharded ingest: packed JPEG coefficients feeding a device mesh per-shard.

Closes the multi-chip gap between transport and compute (VERDICT round 3,
next 4): ``parallel/mesh.py`` shards the pipeline but assumed frames were
already in device memory; the reference's one transport is the MJPEG stream/AVI
(``collecting.py:177-191``, ``marker_detection.py:52``), so the sharded
analog is the packed coefficient transport (ops/jpeg.py) split per data
shard — each device receives ONLY its own frames' sparse coefficients over
its own host->device link and runs the expand + IDCT locally under
``shard_map``. No device ever materializes another shard's frames, and the
per-link byte cost stays the single-device ~2-3 bytes/nonzero.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _data_size(mesh: Mesh) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))["data"]


def _pad_stream(arr: np.ndarray, n: int, fill: int) -> np.ndarray:
    """Pad a packed stream to length ``n`` with its tail-filler convention:
    main streams keep implied positions climbing past the tensor (gap=255 /
    escape 0x87); spill streams pad (gap=0, delta=0) — zero adds are no-ops
    wherever they land (ops/jpeg.py)."""
    if arr.size == n:
        return arr
    out = np.full(n, fill, arr.dtype)
    out[:arr.size] = arr
    return out


class ShardedPackedFeed:
    """Entropy-decode JPEG batches into per-data-shard packed streams and
    expand them to a mesh-sharded frame array.

    Host side: one :class:`~vision_basedsensor_tpu.ops.jpeg.MjpegBatchDecoder`
    entropy-decodes each shard's contiguous frame slice into its own
    HostPacked payload (frames are independent, so the split is exact).
    Device side: the payload stacks ship with a ``P('data')`` sharding — one
    transfer per device link — and a ``shard_map`` expand runs the
    cumsum + sorted scatter + IDCT locally per shard.

    Output frames carry the mesh's canonical frame sharding (rows also split
    over ``spatial`` when the mesh has that axis), ready for
    ``make_sharded_pipeline``'s step without resharding the batch axis.
    """

    def __init__(self, mesh: Mesh, decoder=None, transport: str = "split",
                 zmax: int = 64):
        """``transport``: ``split`` (default — DC/AC separated streams,
        scene-independent bytes per device link), ``tdelta`` (temporal
        coefficient deltas — fewest bytes on slow scenes; each shard's
        slice is self-contained, its first frame shipping absolute), or
        ``packed`` (2-byte delta pairs); see
        :class:`~vision_basedsensor_tpu.ops.jpeg.MjpegBatchDecoder`.
        ``zmax`` (split/tdelta): zigzag band limit — 64 exact, lower the
        detect-grade profile (ops/jpeg.py header)."""
        from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
        if transport not in ("tdelta", "split", "packed"):
            raise ValueError(
                f"transport must be tdelta|split|packed, got {transport}")
        if zmax != 64 and transport not in ("split", "tdelta"):
            raise ValueError(
                "zmax band limit requires transport='split'|'tdelta'")
        self.mesh = mesh
        self._dec = decoder if decoder is not None else MjpegBatchDecoder()
        self._transport = transport
        self._zmax = zmax
        self._expand_cache: dict = {}

    @property
    def last_stats(self) -> dict | None:
        return self._dec.last_stats

    def decode_packed(self, jpegs: list[bytes]) -> jnp.ndarray:
        """Batch of same-geometry JPEGs -> mesh-sharded (B, H, W) float32.

        ``len(jpegs)`` must divide evenly by the mesh's data axis (callers
        batch at a multiple of it; pad the final short chunk with repeats
        and slice, as shard_frames does for raw frames).
        """
        d = _data_size(self.mesh)
        n = len(jpegs)
        if n % d != 0:
            raise ValueError(f"batch of {n} frames does not divide the data "
                             f"axis ({d}); pad the final chunk")
        per = n // d
        if self._transport in ("split", "tdelta"):
            dec = functools.partial(
                {"split": self._dec.entropy_decode_split,
                 "tdelta": self._dec.entropy_decode_tdelta}[self._transport],
                zmax=self._zmax)
        else:
            dec = self._dec.entropy_decode_packed
        shards = [dec(jpegs[i * per:(i + 1) * per]) for i in range(d)]
        geo = {(s.height, s.width, s.grid) for s in shards}
        if len(geo) != 1:
            raise ValueError(f"geometry changed inside a batch: {geo}")
        h, w = shards[0].height, shards[0].width
        grid = shards[0].grid
        qtables = np.stack([s.qtables for s in shards])  # (d, per, 64)
        data_sh = NamedSharding(self.mesh, P("data"))
        put = lambda a: jax.device_put(a, data_sh)  # noqa: E731

        # Uniform stream lengths across shards (shard_map blocks must be
        # equal): pad every shard to the max bucket with tail fillers.
        if self._transport == "tdelta":
            a_cap = max(s.ac.size for s in shards)
            s_cap = max(s.sgaps.size for s in shards)
            expand = self._expand_for(h, w, grid)
            return expand(
                put(np.stack([_pad_stream(s.ac, a_cap, 0x86)
                              for s in shards])),
                put(np.stack([_pad_stream(s.sgaps, s_cap, 0)
                              for s in shards])),
                put(np.stack([_pad_stream(s.sdeltas, s_cap, 0)
                              for s in shards])),
                put(qtables))
        if self._transport == "split":
            a_cap = max(s.ac.size for s in shards)
            s_cap = max(s.sgaps.size for s in shards)
            d_cap = max(s.dgaps.size for s in shards)
            expand = self._expand_for(h, w, grid)
            return expand(
                put(np.stack([_pad_stream(s.ac, a_cap, 0x87)
                              for s in shards])),
                put(np.stack([s.dc for s in shards])),
                put(np.stack([_pad_stream(s.sgaps, s_cap, 0)
                              for s in shards])),
                put(np.stack([_pad_stream(s.sdeltas, s_cap, 0)
                              for s in shards])),
                put(np.stack([_pad_stream(s.dgaps, d_cap, 0)
                              for s in shards])),
                put(np.stack([_pad_stream(s.ddeltas, d_cap, 0)
                              for s in shards])),
                put(qtables))
        e_cap = max(s.gaps.size for s in shards)
        s_cap = max(s.sgaps.size for s in shards)
        expand = self._expand_for(h, w, grid)
        return expand(
            put(np.stack([_pad_stream(s.gaps, e_cap, 255) for s in shards])),
            put(np.stack([_pad_stream(s.vals, e_cap, 0) for s in shards])),
            put(np.stack([_pad_stream(s.sgaps, s_cap, 0) for s in shards])),
            put(np.stack([_pad_stream(s.sdeltas, s_cap, 0) for s in shards])),
            put(qtables))

    def _expand_for(self, h: int, w: int, grid: tuple[int, int]):
        key = (self._transport, h, w, grid, self._zmax)
        if key not in self._expand_cache:
            from vision_basedsensor_tpu.ops.jpeg import (delta_idct_frames,
                                                         split_idct_frames,
                                                         tdelta_idct_frames)
            from vision_basedsensor_tpu.parallel.mesh import _frame_spec

            mesh = self.mesh
            out_spec = _frame_spec(mesh)

            if self._transport == "tdelta":
                def _local(ac, sg, sd, q):
                    # Local blocks are (1, cap) / (1, per, 64): one shard,
                    # whose slice is a self-contained tdelta batch.
                    return tdelta_idct_frames(ac[0], sg[0], sd[0], q[0],
                                              height=h, width=w, grid=grid,
                                              zmax=self._zmax)
                n_in = 4
            elif self._transport == "split":
                def _local(ac, dc, sg, sd, dg, dd, q):
                    # Local blocks are (1, cap) / (1, per, 64): one shard.
                    return split_idct_frames(ac[0], dc[0], sg[0], sd[0],
                                             dg[0], dd[0], q[0],
                                             height=h, width=w, grid=grid,
                                             zmax=self._zmax)
                n_in = 7
            else:
                def _local(g, v, sg, sd, q):
                    # Rows stay whole per shard; the jit-level constraint
                    # below reshards onto `spatial` once, on device.
                    return delta_idct_frames(g[0], v[0], sg[0], sd[0], q[0],
                                             height=h, width=w, grid=grid)
                n_in = 5

            fn = jax.shard_map(_local, mesh=mesh,
                               in_specs=(P("data"),) * n_in,
                               out_specs=P("data"), check_vma=False)

            @jax.jit
            def expand(*streams):
                return jax.lax.with_sharding_constraint(
                    fn(*streams), NamedSharding(mesh, out_spec))

            self._expand_cache[key] = expand
        return self._expand_cache[key]
