"""Stable on-disk serialization for compiled NPU artifacts.

The paper's compiler is a deployment product: a workload is compiled
once and the resulting program ships to millions of edge devices.  This
module gives every compiler artifact a canonical, *versioned* byte form
so a compiled program can leave the process that solved the CPs:

  * component codecs — :class:`~repro_torch.core.ir.Graph` (with dtypes and
    qparams), :class:`~repro_torch.core.program.NPUProgram` (ticks, jobs,
    tiles, meta), :class:`~repro_torch.core.tiling.TilingResult`,
    :class:`~repro_torch.core.allocation.Allocation`,
    :class:`~repro_torch.core.formats.FormatPlan` and
    :class:`~repro_torch.core.npu.NPUConfig` each round-trip through a
    JSON-able payload plus a dict of numpy arrays (arrays never pass
    through JSON, so float32/int8 values are bit-exact);
  * a container format — a single zip file holding ``meta.json``, one
    ``<component>.json`` per payload and one *stored* (uncompressed)
    ``arrays/<name>.npy`` member per array, with a per-entry sha256
    manifest in the meta.  Stored members sit at fixed byte offsets, so
    loaders can memory-map weights copy-on-write straight out of the
    artifact (``read_artifact(mmap_arrays=True)``) — a fleet of serving
    processes shares one page-cache copy per weight.  A flipped byte, a
    truncated file or a hand-edited entry fails the manifest check and
    raises :class:`ArtifactError` — a bad artifact is rejected, never
    replayed.  Version-1 artifacts (one deflated ``arrays.npz``) still
    load.

Consumers: the two-tier compiled-program cache in
:mod:`repro_torch.core.pipeline` (program-only artifacts) and the public
``repro_torch.api`` deployment surface (full ``CompiledModel`` artifacts that
add the graph, weights and quantization state).

Copy of the JAX package's ``core/serialize.py`` (numpy only; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.
"""
from __future__ import annotations

import hashlib
import io
import json
import struct
import zipfile
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .allocation import Allocation
from .formats import FormatPlan
from .ir import Graph, Op, QParams, Tensor
from .npu import NPUConfig
from .program import ComputeJob, DmaJob, NPUProgram, Tick, TileRef, V2PJob
from .tiling import ComputeStep, TensorTiles, TilingResult

#: bump when any payload layout changes incompatibly.  Version 2 stores
#: each numpy array as its own *uncompressed* ``arrays/<name>.npy`` zip
#: member (v1 bundled them in one deflated ``arrays.npz``): stored
#: members sit at a fixed byte offset inside the file, so weights can be
#: memory-mapped copy-on-write straight out of the artifact — a fleet of
#: serving processes shares one page-cache copy per weight instead of
#: each copying every array into RAM.  Version 3 additionally persists
#: the lowered-plan kernel constants (``arrays/pl/…`` members plus a
#: ``planconsts.json`` key index), so a loading worker's first
#: ``plan_for`` serves the derived arrays straight off the map instead
#: of re-gathering/re-casting them from the weights.  Versions 1 and 2
#: still load (they simply recompute the constants).
ARTIFACT_VERSION = 3
_SUPPORTED_VERSIONS = (1, 2, 3)
ARTIFACT_MAGIC = "repro-npu-artifact"


class ArtifactError(RuntimeError):
    """A persisted artifact is corrupted, truncated, from an
    incompatible format version, or stale for the requested key."""


# --------------------------------------------------------------------------
# Small helpers
# --------------------------------------------------------------------------


def _tuplify(v: Any) -> Any:
    """JSON arrays back to tuples (op attrs are built with tuples; the
    executors unpack them positionally)."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def _tile_to_list(tl: TileRef) -> list:
    return [tl.tensor, tl.index, tl.r0, tl.r1, tl.nbytes, tl.banks, tl.axis]


def _tile_from_list(v: list) -> TileRef:
    return TileRef(v[0], int(v[1]), int(v[2]), int(v[3]), int(v[4]),
                   int(v[5]), v[6])


# --------------------------------------------------------------------------
# NPUConfig
# --------------------------------------------------------------------------


def config_to_payload(cfg: NPUConfig) -> dict:
    return asdict(cfg)


def config_from_payload(p: dict) -> NPUConfig:
    return NPUConfig(**p)


# --------------------------------------------------------------------------
# Graph (tensors + qparams + ops)
# --------------------------------------------------------------------------


def graph_to_payload(g: Graph) -> Tuple[dict, Dict[str, np.ndarray]]:
    arrays: Dict[str, np.ndarray] = {}
    tensors = []
    for t in sorted(g.tensors.values(), key=lambda t: t.name):
        qp = None
        if t.qparams is not None:
            qp = {"bits": t.qparams.bits, "axis": t.qparams.axis}
            arrays[f"qp.scale/{t.name}"] = np.asarray(t.qparams.scale)
            arrays[f"qp.zp/{t.name}"] = np.asarray(t.qparams.zero_point)
        tensors.append({
            "name": t.name, "shape": list(t.shape), "kind": t.kind,
            "dtype": t.dtype, "producer": t.producer,
            "consumers": list(t.consumers), "scale": t.scale, "qparams": qp,
        })
    ops = [{"name": op.name, "kind": op.kind, "inputs": list(op.inputs),
            "outputs": list(op.outputs), "attrs": op.attrs}
           for op in g.ops]
    return {"name": g.name, "tensors": tensors, "ops": ops}, arrays


def graph_from_payload(p: dict, arrays: Dict[str, np.ndarray]) -> Graph:
    g = Graph(p["name"])
    for tp in p["tensors"]:
        qp = None
        if tp["qparams"] is not None:
            axis = tp["qparams"]["axis"]
            s = arrays[f"qp.scale/{tp['name']}"]
            z = arrays[f"qp.zp/{tp['name']}"]
            if axis is None and s.size == 1:
                # restore the scalar form per-tensor params were built
                # with (older artifacts stored them as shape (1,)): a
                # 1-element scale array knocks quantize() off its scalar
                # hot path, and the int32 zero-point *array* add then
                # promotes the whole activation chain to float64 —
                # measurably slower replay, same values
                s = s.reshape(())[()]
                z = np.asarray(z).reshape(())[()]
            qp = QParams(s, z,
                         bits=int(tp["qparams"]["bits"]),
                         axis=axis)
        g.tensors[tp["name"]] = Tensor(
            tp["name"], tuple(tp["shape"]), tp["kind"], tp["dtype"],
            tp["producer"], list(tp["consumers"]), tp["scale"], qp)
    for op_p in p["ops"]:
        # "pad"/"k" attrs are tuples in builder-made graphs; JSON returns
        # lists, and the executors unpack them positionally either way,
        # but fingerprint stability and isinstance(k, tuple) checks in
        # in_row_range need the original tuple form back.
        attrs = {k: _tuplify(v) for k, v in op_p["attrs"].items()}
        op = Op(op_p["name"], op_p["kind"], list(op_p["inputs"]),
                list(op_p["outputs"]), attrs)
        g.ops.append(op)
        g._op_index[op.name] = op
    return g


# --------------------------------------------------------------------------
# NPUProgram
# --------------------------------------------------------------------------


def program_to_payload(prog: NPUProgram) -> dict:
    ticks = []
    for t in prog.ticks:
        cj = None
        if t.compute:
            c = t.compute
            cj = {"op": c.op_name,
                  "out": [_tile_to_list(x) for x in c.out_tiles],
                  "in": [_tile_to_list(x) for x in c.in_tiles],
                  "fmt": c.fmt, "cycles": c.cycles, "macs": c.macs,
                  "r0": c.r0, "r1": c.r1, "axis": c.axis}
        ticks.append({
            "index": t.index,
            "compute": cj,
            "dma": [[j.kind, _tile_to_list(j.tile), j.nbytes, j.cycles]
                    for j in t.dma],
            "v2p": [[_tile_to_list(j.tile), list(j.banks), j.cycles]
                    for j in t.v2p],
        })
    meta = dict(prog.meta)
    dead = meta.pop("dead_after_tick", {})
    return {
        "name": prog.name,
        "cfg": config_to_payload(prog.cfg),
        "dm_penalty": prog.dm_penalty,
        "ticks": ticks,
        "meta": meta,
        "dead_after_tick": {str(k): [[n, i] for (n, i) in v]
                            for k, v in dead.items()},
    }


def program_from_payload(p: dict) -> NPUProgram:
    ticks: List[Tick] = []
    for tp in p["ticks"]:
        cj = None
        if tp["compute"] is not None:
            c = tp["compute"]
            cj = ComputeJob(c["op"],
                            [_tile_from_list(x) for x in c["out"]],
                            [_tile_from_list(x) for x in c["in"]],
                            c["fmt"], int(c["cycles"]), int(c["macs"]),
                            r0=c["r0"], r1=c["r1"], axis=c["axis"])
        ticks.append(Tick(
            int(tp["index"]), cj,
            [DmaJob(j[0], _tile_from_list(j[1]), int(j[2]), int(j[3]))
             for j in tp["dma"]],
            [V2PJob(_tile_from_list(j[0]), [int(b) for b in j[1]],
                    int(j[2])) for j in tp["v2p"]],
        ))
    meta = dict(p["meta"])
    meta["dead_after_tick"] = {
        int(k): [(n, int(i)) for n, i in v]
        for k, v in p["dead_after_tick"].items()}
    return NPUProgram(p["name"], config_from_payload(p["cfg"]), ticks,
                      dm_penalty=int(p["dm_penalty"]), meta=meta)


# --------------------------------------------------------------------------
# TilingResult / Allocation / FormatPlan
# --------------------------------------------------------------------------


def tiling_to_payload(tiling: TilingResult) -> dict:
    # ``stats`` round-trips as plain JSON and now carries the fusion
    # coverage record (cp/windowed/greedy/layer-wise region counts,
    # window counts and per-region detail) that CompiledModel.report()
    # surfaces.  ``tiling.fallback`` — the greedy-order race variant the
    # compile ladder may hold transiently — is deliberately NOT
    # persisted: artifacts store only the chosen plan.
    return {
        "tiles": [[name, [_tile_to_list(tl) for tl in tt.tiles]]
                  for name, tt in tiling.tiles.items()],
        "order": [[s.op_name, s.r0, s.r1, s.axis] for s in tiling.order],
        "regions": [list(r) for r in tiling.regions],
        "fusion_objective": tiling.fusion_objective,
        "stats": json.loads(json.dumps(tiling.stats, default=list)),
    }


def tiling_from_payload(p: dict) -> TilingResult:
    tiles = {name: TensorTiles(name, [_tile_from_list(v) for v in tls])
             for name, tls in p["tiles"]}
    order = [ComputeStep(o, int(r0), int(r1), axis)
             for o, r0, r1, axis in p["order"]]
    return TilingResult(tiles, order, [list(r) for r in p["regions"]],
                        p["fusion_objective"], dict(p["stats"]))


def allocation_to_payload(alloc: Allocation) -> dict:
    return {
        "banks": [[n, i, list(b)] for (n, i), b in alloc.banks.items()],
        "tiles": [[n, i, _tile_to_list(tl)]
                  for (n, i), tl in alloc.tiles.items()],
        "peak_banks": alloc.peak_banks,
        "v2p_updates": alloc.v2p_updates,
        "repair_spills": alloc.repair_spills,
        # spill_events are compile-time diagnostics; not persisted
    }


def allocation_from_payload(p: dict) -> Allocation:
    return Allocation(
        banks={(n, int(i)): [int(x) for x in b]
               for n, i, b in p["banks"]},
        tiles={(n, int(i)): _tile_from_list(tl)
               for n, i, tl in p["tiles"]},
        peak_banks=int(p["peak_banks"]),
        v2p_updates=int(p["v2p_updates"]),
        repair_spills=int(p["repair_spills"]),
    )


def plan_to_payload(plan: FormatPlan) -> dict:
    return {"fmt": dict(plan.fmt), "cost_cycles": dict(plan.cost_cycles)}


def plan_from_payload(p: dict) -> FormatPlan:
    return FormatPlan(dict(p["fmt"]),
                      {k: int(v) for k, v in p["cost_cycles"].items()})


# --------------------------------------------------------------------------
# Container: zip of json payloads + arrays.npz with a sha256 manifest
# --------------------------------------------------------------------------


def _json_bytes(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    # ascontiguousarray promotes 0-d to shape (1,) — keep scalar members
    # (per-tensor qparams) 0-d so they round-trip exactly
    a = np.asarray(arr)
    if a.ndim:
        a = np.ascontiguousarray(a)
    np.lib.format.write_array(buf, a, allow_pickle=False)
    return buf.getvalue()


#: mmap alignment for stored array members; matches numpy's own
#: ARRAY_ALIGN so the npy header padding lands array data on the same
#: boundary.
_MEMBER_ALIGN = 64

#: private zip extra-field id for alignment padding (any id unknown to
#: extractors is carried opaquely; the data offset math in
#: ``_member_data_offset`` reads the local header's real extra length).
_PAD_EXTRA_ID = 0xD935


def _aligned_zinfo(zf: zipfile.ZipFile, name: str) -> zipfile.ZipInfo:
    """ZipInfo for a STORED member whose *data* starts 64-byte aligned.

    ``np.lib.format`` pads the npy header so array data sits at a
    64-byte offset within the blob; padding the zip local header with
    an extra field aligns the blob itself, so memory-mapped arrays come
    out SIMD-aligned instead of landing wherever the previous member
    ended (misaligned loads measurably slow elementwise-heavy replay)."""
    zi = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
    zi.compress_type = zipfile.ZIP_STORED
    data_off = zf.start_dir + 30 + len(name.encode("utf-8"))
    pad = -data_off % _MEMBER_ALIGN
    if 0 < pad < 4:                # an extra block is at least 4 bytes
        pad += _MEMBER_ALIGN
    if pad:
        zi.extra = struct.pack("<HH", _PAD_EXTRA_ID, pad - 4) \
            + b"\0" * (pad - 4)
    return zi


def write_artifact(path: str, key: dict, payloads: Dict[str, Any],
                   arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write one artifact file.  ``key`` is the caller's identity record
    (fingerprint / config / options digest / precision …); ``payloads``
    maps component name -> JSON-able payload; ``arrays`` holds every
    numpy array referenced by the payloads.

    JSON payloads are deflated; arrays are **stored** (uncompressed) as
    individual ``arrays/<name>.npy`` members so loaders can memory-map
    them in place (see :func:`read_artifact`'s ``mmap_arrays``)."""
    entries: Dict[str, bytes] = {}
    stored: set = set()
    for name, payload in payloads.items():
        entries[f"{name}.json"] = _json_bytes(payload)
    for name, arr in (arrays or {}).items():
        member = f"arrays/{name}.npy"
        entries[member] = _npy_bytes(arr)
        stored.add(member)
    meta = {
        "magic": ARTIFACT_MAGIC,
        "version": ARTIFACT_VERSION,
        "key": key,
        "manifest": {name: hashlib.sha256(blob).hexdigest()
                     for name, blob in sorted(entries.items())},
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("meta.json", _json_bytes(meta))
        for name, blob in sorted(entries.items()):
            if name in stored:
                zf.writestr(_aligned_zinfo(zf, name), blob)
            else:
                zf.writestr(name, blob,
                            compress_type=zipfile.ZIP_DEFLATED)


def _member_data_offset(path: str, zinfo: zipfile.ZipInfo) -> int:
    """Absolute byte offset of a stored member's data in the zip file.
    The local file header is 30 bytes + filename + extra (the *local*
    extra field can differ from the central directory's, so it is read
    from the header itself)."""
    with open(path, "rb") as f:
        f.seek(zinfo.header_offset)
        hdr = f.read(30)
    if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
        raise ArtifactError(f"{path}: bad local header for "
                            f"{zinfo.filename}")
    fn_len = int.from_bytes(hdr[26:28], "little")
    extra_len = int.from_bytes(hdr[28:30], "little")
    return zinfo.header_offset + 30 + fn_len + extra_len


def _mmap_npy_member(path: str, zinfo: zipfile.ZipInfo
                     ) -> Optional[np.ndarray]:
    """Map one stored ``.npy`` member copy-on-write.  Returns None when
    the member cannot be mapped (compressed, exotic header, zero-size)
    — the caller falls back to an in-memory read."""
    if zinfo.compress_type != zipfile.ZIP_STORED:
        return None
    try:
        data_off = _member_data_offset(path, zinfo)
        with open(path, "rb") as f:
            f.seek(data_off)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            else:
                return None
            offset = f.tell()
    except (OSError, ValueError, ArtifactError):
        return None
    if dtype.hasobject or int(np.prod(shape)) == 0:
        return None
    # mode "c" (copy-on-write): reads share the OS page cache across
    # processes; an in-place write (e.g. a spill push-back during
    # interpretive replay) dirties a private page instead of faulting
    m = np.memmap(path, dtype=dtype, mode="c", offset=offset,
                  shape=shape, order="F" if fortran else "C")
    # hand back a plain-ndarray view: the mapping stays alive through
    # ``.base``, but ufuncs no longer propagate the memmap subclass —
    # subclass dispatch on every intermediate taxes interpreted plans
    # by whole milliseconds per batch
    return m.view(np.ndarray)


def read_artifact(path: str, mmap_arrays: bool = False
                  ) -> Tuple[dict, Dict[str, Any], Dict[str, np.ndarray]]:
    """Read + integrity-check one artifact file.

    Returns ``(key, payloads, arrays)``.  Raises :class:`ArtifactError`
    on any corruption: bad zip, missing/extra entries vs the manifest,
    sha256 mismatch, wrong magic or incompatible version.

    ``mmap_arrays=True`` maps version-2 stored ``.npy`` members
    copy-on-write instead of materializing them in RAM.  Every member —
    mapped or not — is still streamed through the full sha256 manifest
    check first; mapping never weakens the integrity contract."""
    try:
        with zipfile.ZipFile(path, "r") as zf:
            try:
                meta = json.loads(zf.read("meta.json"))
            except KeyError:
                raise ArtifactError(f"{path}: no meta.json")
            if meta.get("magic") != ARTIFACT_MAGIC:
                raise ArtifactError(f"{path}: not a repro NPU artifact")
            version = meta.get("version")
            if version not in _SUPPORTED_VERSIONS:
                raise ArtifactError(
                    f"{path}: artifact version {version} "
                    f"incompatible with {ARTIFACT_VERSION}")
            manifest = meta.get("manifest", {})
            names = set(zf.namelist()) - {"meta.json"}
            if names != set(manifest):
                raise ArtifactError(
                    f"{path}: entry set {sorted(names)} does not match "
                    f"manifest {sorted(manifest)}")
            payloads: Dict[str, Any] = {}
            arrays: Dict[str, np.ndarray] = {}
            for name, want in manifest.items():
                is_array = name.startswith("arrays/") \
                    and name.endswith(".npy")
                if is_array and mmap_arrays:
                    # stream the checksum; never hold the whole blob
                    h = hashlib.sha256()
                    with zf.open(name) as fh:
                        for chunk in iter(lambda: fh.read(1 << 20), b""):
                            h.update(chunk)
                    if h.hexdigest() != want:
                        raise ArtifactError(
                            f"{path}: checksum mismatch on {name}")
                    arr = _mmap_npy_member(path, zf.getinfo(name))
                    if arr is None:
                        arr = np.lib.format.read_array(
                            io.BytesIO(zf.read(name)), allow_pickle=False)
                    arrays[name[7:-4]] = arr
                    continue
                blob = zf.read(name)
                got = hashlib.sha256(blob).hexdigest()
                if got != want:
                    raise ArtifactError(
                        f"{path}: checksum mismatch on {name}")
                if is_array:
                    arrays[name[7:-4]] = np.lib.format.read_array(
                        io.BytesIO(blob), allow_pickle=False)
                elif name == "arrays.npz":           # version-1 layout
                    with np.load(io.BytesIO(blob)) as npz:
                        arrays = {k: npz[k] for k in npz.files}
                elif name.endswith(".json"):
                    payloads[name[:-5]] = json.loads(blob)
    except zipfile.BadZipFile as e:
        raise ArtifactError(f"{path}: unreadable artifact ({e})") from e
    return meta["key"], payloads, arrays


def options_digest(opts_key: tuple) -> str:
    """Stable digest of a CompilerOptions.cache_key() tuple (its repr is
    deterministic: strings, numbers, bools, None and nested tuples)."""
    return hashlib.sha256(repr(opts_key).encode()).hexdigest()


def cache_file_key(fingerprint: str, cfg: NPUConfig, opts_key: tuple) -> str:
    """Filename-safe digest of the full compiled-program cache key."""
    return cache_file_key_digest(fingerprint, config_to_payload(cfg),
                                 options_digest(opts_key))


def cache_file_key_digest(fingerprint: str, cfg_payload: dict,
                          opts_digest: str) -> str:
    """Same digest, from the already-serialized key components (what an
    artifact's own key record stores — lets auditors re-derive the
    expected filename of any artifact from its contents)."""
    blob = _json_bytes({"fp": fingerprint, "cfg": cfg_payload,
                        "opts": opts_digest})
    return hashlib.sha256(blob).hexdigest()
