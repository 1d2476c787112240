"""Multi-chip scaling via jax.sharding over a device mesh.

The reference has no distributed execution at all (SURVEY.md §2, §5.8); the
sensor pipeline's natural multi-chip axes are:

* ``data``: the frame batch — embarrassingly parallel through detection,
  association and back-projection (there is no model state to shard);
* ``spatial``: the image height — XLA's SPMD partitioner handles the
  convolution halos, useful when single-frame latency matters.

The one sequential coupling is the last-sighting displacement scan
(reconstruct/displacement.py). Its state is tiny — 65 markers x 3 floats per
frame — so the design replicates it: a sharding constraint before the scan
makes XLA all-gather the per-frame marker tensors (a few KB between
devices) and every device runs the identical scan, keeping the heavy pixel
work fully sharded with no cross-device serialization. The devices of one
host are joined all to all, so the mesh follows the algorithm alone.

On a data-only mesh the detect stage runs under EXPLICIT ``jax.shard_map``
rather than GSPMD auto-partitioning: detection is purely per-frame, and
shard_map states that contract — each device executes the single-device
detect program on its local frame block, and the partitioner gets no
chance to replicate or exchange inside the candidate gathers and
``top_k``. ``collective_ops_in_hlo`` checks the outcome: the scan-state
all-gather is the step's only collective. Spatial (row-sharded) meshes
use GSPMD, which inserts the filters' halo exchanges.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vision_basedsensor_tpu.config import PipelineConfig
from vision_basedsensor_tpu.core.camera import CameraModel
from vision_basedsensor_tpu.detect import detect_markers
from vision_basedsensor_tpu.pipeline import (PipelineOutputs, _preprocess,
                                             prepare_undistortion)
from vision_basedsensor_tpu.reconstruct import displacement_scan
from vision_basedsensor_tpu.reconstruct.displacement import warmup_mask
from vision_basedsensor_tpu.track import (ReferenceMarkers, associate,
                                          associate_sequential)
from vision_basedsensor_tpu.reconstruct.depth import reconstruct_positions


def make_mesh(devices=None, spatial: int = 1) -> Mesh:
    """Create a ``(data[, spatial])`` mesh over the given (or all) devices."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if spatial > 1:
        assert n % spatial == 0, (n, spatial)
        import numpy as np
        arr = np.array(devices).reshape(n // spatial, spatial)
        return Mesh(arr, ("data", "spatial"))
    import numpy as np
    return Mesh(np.array(devices), ("data",))


def shard_frames(frames: jnp.ndarray, mesh: Mesh,
                 pad: bool = True) -> jnp.ndarray:
    """Place a frame batch with (batch, height) sharded per the mesh axes.

    Batches not divisible by the data axis are zero-padded at the tail
    (``pad=True``): zero frames produce no detections, so ``seen`` is False
    for them and the displacement scan's carry is untouched — callers just
    slice outputs back to the true batch length (``out.recon.world[:B]``).
    """
    import numpy as np
    spec = _frame_spec(mesh)
    n = dict(zip(mesh.axis_names, mesh.devices.shape))["data"]
    rem = (-frames.shape[0]) % n
    if rem and pad:
        # Pad on the HOST: jnp.concatenate would materialize the full
        # padded batch on the default device before resharding, capping the
        # shardable batch at one chip's HBM and adding a dev0->mesh
        # transfer (round-3 review). device_put of a host array shards
        # directly.
        host = np.asarray(frames)
        frames = np.concatenate(
            [host, np.zeros((rem,) + host.shape[1:], host.dtype)])
    return jax.device_put(frames, NamedSharding(mesh, spec))


def _frame_spec(mesh: Mesh) -> P:
    if "spatial" in mesh.axis_names:
        return P("data", "spatial")
    return P("data")


def make_sharded_pipeline(mesh: Mesh, cam: CameraModel, cfg: PipelineConfig,
                          crop: bool = False, apply_warmup: bool = False,
                          with_carry: bool = False):
    """Build the jitted SPMD pipeline step for the given mesh.

    Returns ``step(frames, ref) -> PipelineOutputs`` with the frame batch
    sharded on ``data`` (and image rows on ``spatial`` if present) and the
    reference marker table replicated. Uneven batches (B not divisible by
    the data axis) are supported — GSPMD pads the ragged shard internally.

    ``with_carry``: the step becomes ``step(frames, ref, carry) ->
    (PipelineOutputs, carry)`` carrying the replicated displacement-scan
    state across chunk boundaries, so a sharded session can checkpoint and
    resume exactly like the single-device StreamingPipeline (io/session.py
    stores the same carry dict). With ``association_mode='sequential'`` the
    carry becomes ``(scan_carry, assoc_xy)`` — the last-sighting positions
    ride along with the displacement state.

    Honors the full PipelineConfig like the single-device pipeline:
    ``cfg.undistort_frames`` rectifies frames before detection (the map is
    built at trace time from the static frame shape; reconstruction uses
    the rectified camera), and ``cfg.track.association_mode='sequential'``
    runs the last-sighting scan on replicated detections — like the
    displacement scan, the per-frame candidate table is a few hundred KB,
    so every device runs the identical scan while the pixel work stays
    sharded.
    """
    frame_sharding = NamedSharding(mesh, _frame_spec(mesh))
    replicated = NamedSharding(mesh, P())
    sequential = cfg.track.association_mode == "sequential"
    spatial = "spatial" in mesh.axis_names
    n_data = dict(zip(mesh.axis_names, mesh.devices.shape))["data"]

    detect_cfg = cfg.detect

    def _detect_sharded(frames_c, axis_scale):
        """Detect under explicit shard_map on the data axis.

        Each device runs the single-device detect program on its LOCAL
        (B/n, H, W) block — the code path the single-device tests cover.
        Detection is purely per-frame, so no collectives are needed inside
        the region. The batch is padded to a multiple of the data axis
        (zero frames yield no detections) and sliced back after.
        """
        b = frames_c.shape[0]
        pad = (-b) % n_data
        if pad:
            frames_c = jnp.concatenate(
                [frames_c, jnp.zeros((pad,) + frames_c.shape[1:],
                                     frames_c.dtype)])
        frames_c = jax.lax.with_sharding_constraint(
            frames_c, NamedSharding(mesh, P("data")))
        fn = jax.shard_map(
            lambda f, s: detect_markers(f, detect_cfg, axis_scale=s),
            mesh=mesh, in_specs=(P("data"), P()), out_specs=P("data"),
            check_vma=False)
        det = fn(frames_c, axis_scale)
        if pad:
            det = jax.tree.map(lambda v: v[:b], det)
        return det

    # The rectify map is a host-side numpy precomputation over the static
    # frame shape (it cannot run inside the jit trace); it is built lazily
    # on the first call and the jitted step re-built per frame shape.
    prep_cache: dict = {}

    def _prep_for(shape):
        hw = tuple(int(d) for d in shape[1:3])   # the map ignores batch size
        if hw not in prep_cache:
            if cfg.undistort_frames:
                prep_cache[hw] = prepare_undistortion(cam, hw[0], hw[1],
                                                      cfg, crop)
            else:
                prep_cache[hw] = (None, cam)
        return prep_cache[hw]

    def _body(frames: jnp.ndarray, ref: ReferenceMarkers, carry, assoc_xy,
              rectify_map, recon_cam, offset):
        frames_c = _preprocess(frames, cfg, crop, rectify_map)
        if spatial:
            # Keep the frames row-sharded through the (XLA) filter stack;
            # GSPMD inserts the conv halo exchanges.
            det = detect_markers(frames_c, detect_cfg,
                                 axis_scale=ref.axis_scale)
        else:
            det = _detect_sharded(frames_c, ref.axis_scale)
        if sequential:
            # The last-sighting association is a scan over the frame axis;
            # replicate the small per-frame candidate table (like the
            # displacement scan below) so every device runs it identically.
            det = jax.tree.map(
                lambda v: jax.lax.with_sharding_constraint(v, replicated),
                det)
            tracked, assoc_out = associate_sequential(
                ref, det, cfg.track.min_marker_distance_px,
                carry_xy=assoc_xy, return_carry=True)
        else:
            tracked = associate(ref, det, cfg.track.min_marker_distance_px)
            assoc_out = assoc_xy
        world, ok = reconstruct_positions(
            recon_cam, tracked.xy, tracked.axes, tracked.valid,
            cfg.reconstruct)
        if apply_warmup:
            # GLOBAL frame index: a carried (chunked) session must mask only
            # the first warmup_frames of the whole stream, not of every
            # chunk (round-3 review; StreamingPipeline._chunk threads the
            # same offset through the shared helper).
            world, ok = warmup_mask(world, ok,
                                    cfg.reconstruct.warmup_frames, offset)
        # Replicate the tiny per-marker state so every device runs the
        # identical scan; XLA inserts one all-gather of (B, 65, 3+1).
        world = jax.lax.with_sharding_constraint(world, replicated)
        ok = jax.lax.with_sharding_constraint(ok, replicated)
        recon, carry_out = displacement_scan(world, ok, cfg.reconstruct,
                                             carry=carry, return_carry=True)
        from vision_basedsensor_tpu.analysis.force import contact_state_sequence
        contact = contact_state_sequence(recon, cfg.analysis)
        out = PipelineOutputs(detections=det, tracked=tracked, recon=recon,
                              contact=contact)
        if not with_carry:
            return out
        return (out, (carry_out, assoc_out)) if sequential \
            else (out, carry_out)

    def _make_step(rectify_map, recon_cam):
        if with_carry and sequential:
            @functools.partial(jax.jit,
                               in_shardings=(frame_sharding, replicated,
                                             replicated, replicated,
                                             replicated),
                               donate_argnums=(0,))
            def jstep(frames, ref, carry, assoc_xy, offset):
                return _body(frames, ref, carry, assoc_xy, rectify_map,
                             recon_cam, offset)
        elif with_carry:
            @functools.partial(jax.jit,
                               in_shardings=(frame_sharding, replicated,
                                             replicated, replicated),
                               donate_argnums=(0,))
            def jstep(frames, ref, carry, offset):
                return _body(frames, ref, carry, None, rectify_map,
                             recon_cam, offset)
        else:
            @functools.partial(jax.jit,
                               in_shardings=(frame_sharding, replicated,
                                             replicated),
                               donate_argnums=(0,))
            def jstep(frames, ref, offset):
                return _body(frames, ref, None, None, rectify_map,
                             recon_cam, offset)
        return jstep

    step_cache: dict = {}

    def _jitted_for(frames):
        shape = tuple(frames.shape)
        if shape not in step_cache:
            step_cache[shape] = _make_step(*_prep_for(shape))
        return step_cache[shape]

    def step(frames, *rest, n_frames: int | None = None):
        off = jnp.int32(step.frames_seen if with_carry else 0)
        out = _jitted_for(frames)(frames, *rest, off)
        if with_carry:
            # Auto-count for the warmup offset. ``shard_frames`` zero-pads
            # ragged chunks, and counting those pad frames mid-session would
            # permanently inflate the offset for every later chunk — callers
            # feeding a padded chunk pass the TRUE frame count via
            # ``n_frames`` (pads in a *final* chunk are harmless either
            # way). Callers resuming a checkpoint set step.frames_seen from
            # the session (io/session.py).
            step.frames_seen += int(frames.shape[0] if n_frames is None
                                    else n_frames)
        return out

    step.frames_seen = 0
    # Expose the shape-resolved jitted function (collective_ops_in_hlo and
    # AOT users need .lower()).
    step.jitted_for = _jitted_for
    return step


def collective_ops_in_hlo(step, *example_args) -> list[str]:
    """Names of cross-device collective ops in the step's compiled HLO.

    Evidence hook for tests: on a data-only mesh the pipeline's ONLY
    collective should be the all-gather that replicates the (B, 65) scan
    state (plus any trailing output resharding) — no all-reduces, no
    all-to-alls, no halo exchanges.
    """
    import re
    if hasattr(step, "jitted_for"):   # make_sharded_pipeline wrapper
        step = step.jitted_for(example_args[0])
        example_args = (*example_args, jnp.int32(0))   # the warmup offset
    text = step.lower(*example_args).compile().as_text()
    # Negative lookahead: 'all-gather-done(' would otherwise match the
    # 'all-gather' alternative ('-' is a word boundary), double-counting
    # every async pair of an accelerator's HLO.
    pat = re.compile(r"\b(all-gather(?:-start)?|all-reduce(?:-start)?|"
                     r"all-to-all|collective-permute(?:-start)?|"
                     r"reduce-scatter)\b(?!-done)")
    # Instruction definitions look like "%name = type op-name(...)"; count
    # each op instance once (skip the -done halves of async pairs).
    ops = []
    for line in text.splitlines():
        if "=" not in line:
            continue
        m = pat.search(line.split("=", 1)[1])
        if m:
            ops.append(m.group(1))
    return ops
