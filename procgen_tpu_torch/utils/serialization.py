"""Per-env state blobs (reference get_state/set_state, vecgame.cpp:485-505).

The counterpart of ``procgen_tpu.utils.serialization`` and of the pack /
unpack half of ``procgen_tpu.utils.native_codec``, in numpy and
vectorised over envs.  A blob is ``b"PGTPU001"``, then for every leaf of
the state a little-endian u32 byte length and that env's raw bytes, then
the reference's 0xCAFECAFE end marker.  The leaves are the JAX package's
``jax.tree_util.tree_leaves`` of its flax ``BasicState``: the dataclass
fields in order, nested ones in turn, ``None`` skipped, each in the JAX
dtype (the mt19937 words as uint32, as ``bridge.state_to_numpy`` gives
them).  So the port's blob of a state is the JAX package's blob of the
same state, byte for byte, and a checkpoint moves between the packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAGIC = b"PGTPU001"
END_OF_BUFFER = 0xCAFECAFE  # vecgame.cpp:6

_U8 = np.uint8


def _walk(v, name=""):
    """(field name, tensor) of every leaf, in the JAX package's order."""
    if v is None:
        return
    if dataclasses.is_dataclass(v):
        for f in dataclasses.fields(v):
            yield from _walk(getattr(v, f.name), f.name)
    else:
        yield name, v


def state_leaves(states) -> list:
    """The leaves of a batched port state as numpy arrays in the JAX
    dtypes, in the JAX package's leaf order."""
    out = []
    for name, t in _walk(states):
        a = t.detach().cpu().numpy()
        if name == "mt":
            a = a.astype(np.uint32)
        out.append(a)
    return out


def _with_leaves(template, it):
    if template is None:
        return None
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _with_leaves(getattr(template, f.name), it)
            for f in dataclasses.fields(template)
        })
    a = next(it)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(template.device)


def _u32_bytes(v: int) -> np.ndarray:
    return np.frombuffer(np.uint32(v).astype("<u4").tobytes(), _U8)


def pack_leaves(leaves, num: int) -> list:
    """Per-env blobs from batched numpy leaves (leading axis ``num``): one
    ``[num, blob_size]`` byte matrix, built by one concatenation."""
    parts = [np.broadcast_to(np.frombuffer(MAGIC, _U8), (num, len(MAGIC)))]
    for a in leaves:
        raw = np.ascontiguousarray(a).reshape(num, -1).view(_U8)
        parts.append(np.broadcast_to(_u32_bytes(raw.shape[1]), (num, 4)))
        parts.append(raw)
    parts.append(np.broadcast_to(_u32_bytes(END_OF_BUFFER), (num, 4)))
    buf = np.concatenate(parts, axis=1)
    return [row.tobytes() for row in buf]


def unpack_leaves(blobs, like) -> list:
    """Batched numpy leaves shaped and typed as ``like`` (one per leaf,
    leading axis ``len(blobs)``) from per-env blobs.  Raises ValueError on
    a blob of the wrong size, a bad magic, a leaf length that is not the
    leaf's, or a missing end marker (``unpack_states`` of the native
    codec)."""
    num = len(blobs)
    sizes = [a.nbytes // num for a in like]
    bs = len(MAGIC) + sum(4 + s for s in sizes) + 4
    for e, b in enumerate(blobs):
        if not isinstance(b, (bytes, bytearray, memoryview)) or len(b) != bs:
            raise ValueError(f"malformed state blob for env {e}: "
                             f"{len(b) if hasattr(b, '__len__') else type(b)} bytes, "
                             f"want {bs}")
    buf = np.frombuffer(b"".join(bytes(b) for b in blobs), _U8).reshape(num, bs)

    def check(ok, what):
        bad = np.nonzero(~ok)[0]
        if bad.size:
            raise ValueError(f"malformed state blob for env {int(bad[0])}: {what}")

    check((buf[:, :len(MAGIC)] == np.frombuffer(MAGIC, _U8)).all(axis=1), "bad magic")
    off = len(MAGIC)
    out = []
    for a, size in zip(like, sizes):
        n = np.ascontiguousarray(buf[:, off:off + 4]).view("<u4")[:, 0]
        check(n == size, f"a leaf's length field is not {size}")
        off += 4
        raw = np.ascontiguousarray(buf[:, off:off + size])
        out.append(raw.view(a.dtype).reshape((num,) + a.shape[1:]))
        off += size
    end = np.ascontiguousarray(buf[:, off:off + 4]).view("<u4")[:, 0]
    check(end == END_OF_BUFFER, "no end marker (truncated)")
    return out


def states_to_bytes(states) -> list:
    """Per-env blobs of a batched port state."""
    return pack_leaves(state_leaves(states), states.num)


def states_from_bytes(blobs, template):
    """A batched port state from per-env blobs, shaped as ``template`` and
    on its device."""
    if len(blobs) != template.num:
        raise ValueError(f"need {template.num} state blobs, got {len(blobs)}")
    like = [
        np.empty(tuple(t.shape), np.uint32 if name == "mt"
                 else torch.empty(0, dtype=t.dtype).numpy().dtype)
        for name, t in _walk(template)
    ]
    leaves = unpack_leaves(list(blobs), like)
    return _with_leaves(template, iter(leaves))
