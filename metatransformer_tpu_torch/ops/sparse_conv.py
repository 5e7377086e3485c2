"""Sparse 3D convolution on fixed-capacity active-voxel lists.

Port of ``metatransformer_tpu/ops/sparse_conv.py``, which replaces the
spconv engine the reference's voxel backbones depend on:

* a :class:`SparseTensor` is a fixed-capacity voxel list: ``features
  [N, C]``, ``coords [N, 4]`` (batch, z, y, x) and a ``valid [N]`` mask;
* neighbour lookup is sorted linearised keys and a binary search
  (``torch.searchsorted``), rebuilt for each active set: the counterpart of
  spconv's hash rulebook;
* a convolution is one gather of the k^3 neighbourhood ``[N, K, Cin]`` and
  one matmul with the ``[K*Cin, Cout]`` kernel;
* a submanifold conv keeps the active set; a strided conv emits the
  downsampled input positions, the first occurrence of each kept and the
  duplicates masked invalid. spconv also emits the kernel-reachable
  positions whose centre is empty; the reference drops them to keep its
  capacity static, and so does the port;
* batch norm over the active voxels uses masked batch statistics.

Keys are int64 here (the reference's are int32, which caps a batch at
``2**31`` cells); the sentinel of an invalid key is the largest int64, so
it sorts last as the reference's ``2**31 - 1`` does. Every sort is stable,
as ``jnp.argsort``: the strided conv's "first occurrence wins" rests on it.
Coordinates are int64.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.ops.gates import gated_relu

SENTINEL = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    features: torch.Tensor  # [N, C]
    coords: torch.Tensor  # [N, 4] int64: (batch, z, y, x)
    valid: torch.Tensor  # [N] bool
    spatial_shape: Tuple[int, int, int]  # (D, H, W)
    batch_size: int

    @property
    def capacity(self) -> int:
        return self.features.shape[0]


def _linearize(coords: torch.Tensor, valid: torch.Tensor,
               spatial_shape: Tuple[int, int, int]) -> torch.Tensor:
    """[N, 4] -> int64 keys; out-of-bounds or invalid -> SENTINEL."""
    d, h, w = spatial_shape
    b, z, y, x = coords.unbind(-1)
    inb = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w) & valid
    key = ((b * d + z) * h + y) * w + x
    return torch.where(inb, key, SENTINEL)


def build_lookup(st: SparseTensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sorted_keys [N], order [N]): the reusable rulebook."""
    keys = _linearize(st.coords, st.valid, st.spatial_shape)
    return torch.sort(keys, stable=True)


def lookup(sorted_keys: torch.Tensor, order: torch.Tensor,
           query_keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """query [M] keys -> (source row index [M], found [M])."""
    n = sorted_keys.shape[0]
    idx = torch.searchsorted(sorted_keys, query_keys).clamp(0, n - 1)
    found = (sorted_keys[idx] == query_keys) & (query_keys != SENTINEL)
    return order[idx], found


def _offsets(kernel: Tuple[int, int, int]) -> np.ndarray:
    """k^3 integer offsets, kernel-centred, in weight-layout order."""
    kd, kh, kw = kernel
    g = np.stack(np.meshgrid(np.arange(kd), np.arange(kh), np.arange(kw), indexing="ij"),
                 -1).reshape(-1, 3)
    return g - np.array([kd // 2, kh // 2, kw // 2])


def gather_rows(features: torch.Tensor, src: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """``features[src]``, zero where not ``found``. A row not found reads a
    row of its own (its position modulo the list) instead of wherever the
    lookup stopped: the values are masked either way, but the gradient's
    scatter then has no long run of one index, which CUDA's indexing
    backward walks one element at a time."""
    own = torch.arange(src.numel(), device=src.device).view(src.shape) % features.shape[0]
    return features[torch.where(found, src, own)] * found[..., None].to(features.dtype)


def _gather_neighborhood(st: SparseTensor, centers: torch.Tensor, center_valid: torch.Tensor,
                         offsets: np.ndarray, sorted_keys: torch.Tensor,
                         order: torch.Tensor) -> torch.Tensor:
    """-> [N, K, Cin] neighbour features (zeros where absent). ``centers``
    [N, 3] are the zyx positions the kernel is centred on."""
    n, k = centers.shape[0], offsets.shape[0]
    q = centers[:, None, :] + torch.as_tensor(offsets, device=centers.device)[None]
    qc = torch.cat([st.coords[:, None, :1].expand(n, k, 1), q], -1).reshape(n * k, 4)
    qkeys = _linearize(qc, center_valid.repeat_interleave(k), st.spatial_shape)
    src, found = lookup(sorted_keys, order, qkeys)
    return gather_rows(st.features, src, found).reshape(n, k, -1)


def _conv_matmul(neigh: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    kd, kh, kw, cin, cout = weight.shape
    return neigh.reshape(neigh.shape[0], kd * kh * kw * cin) @ weight.reshape(-1, cout)


def subm_conv3d(st: SparseTensor, weight: torch.Tensor, rulebook=None) -> SparseTensor:
    """Submanifold conv (spconv.SubMConv3d): the output active set is the
    input's. ``weight`` [kd, kh, kw, Cin, Cout]; the rulebook can be shared
    by layers of one active set (the reference's ``indice_key``)."""
    kd, kh, kw = weight.shape[:3]
    sorted_keys, order = rulebook if rulebook is not None else build_lookup(st)
    neigh = _gather_neighborhood(st, st.coords[:, 1:], st.valid, _offsets((kd, kh, kw)),
                                 sorted_keys, order)
    out = _conv_matmul(neigh, weight) * st.valid[:, None].to(st.features.dtype)
    return dataclasses.replace(st, features=out)


def sparse_conv3d(st: SparseTensor, weight: torch.Tensor, stride: Tuple[int, int, int],
                  padding: Tuple[int, int, int]) -> SparseTensor:
    """Strided sparse conv (spconv.SparseConv3d). The output active set is
    the deduplicated downsampled input positions (see the module
    docstring)."""
    kd, kh, kw = weight.shape[:3]
    kern, strd, padd = np.array([kd, kh, kw]), np.array(stride), np.array(padding)
    d, h, w = st.spatial_shape
    out_shape = tuple(int(v) for v in (np.array([d, h, w]) + 2 * padd - kern) // strd + 1)
    dev = st.coords.device

    zyx = st.coords[:, 1:]
    out_zyx = torch.div(zyx + torch.as_tensor(padd - kern // 2, device=dev),
                        torch.as_tensor(strd, device=dev), rounding_mode="floor")
    out_coords = torch.cat([st.coords[:, :1], out_zyx], -1)
    inb = ((out_zyx >= 0) & (out_zyx < torch.as_tensor(out_shape, device=dev))).all(-1)
    out_valid = st.valid & inb
    out_keys = _linearize(out_coords, out_valid, out_shape)
    sk, order = torch.sort(out_keys, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sk[1:] != sk[:-1]])
    uniq = torch.zeros_like(out_valid)
    uniq[order] = first & (sk != SENTINEL)

    # the input neighbourhood of each output position:
    # input position = o * stride - pad + kk (kernel-corner order)
    corner = _offsets((kd, kh, kw)) + np.array([kd // 2, kh // 2, kw // 2])
    in_centers = out_zyx * torch.as_tensor(strd, device=dev) - torch.as_tensor(padd, device=dev)
    sorted_keys_in, order_in = build_lookup(st)
    neigh = _gather_neighborhood(st, in_centers, out_valid, corner, sorted_keys_in, order_in)
    out = _conv_matmul(neigh, weight) * uniq[:, None].to(st.features.dtype)
    return SparseTensor(features=out, coords=out_coords, valid=uniq, spatial_shape=out_shape,
                        batch_size=st.batch_size)


def batch_norm_relu(st: SparseTensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-3, relu: bool = True) -> SparseTensor:
    """BatchNorm1d over the active voxels (masked batch statistics), then
    ReLU (:func:`.gates.gated_relu`): the reference's norm_fn (+ ReLU) after
    every sparse conv."""
    f = st.features.to(torch.promote_types(st.features.dtype, torch.float32))
    m = st.valid.to(f.dtype)[:, None]
    cnt = m.sum().clamp_min(1.0)
    mean = (f * m).sum(0) / cnt
    var = ((f - mean).square() * m).sum(0) / cnt
    f = (f - mean) * torch.rsqrt(var + eps) * scale + bias
    if relu:
        f = gated_relu(f)
    return dataclasses.replace(st, features=(f * m).to(st.features.dtype))


def to_dense(st: SparseTensor) -> torch.Tensor:
    """-> [B, D, H, W, C] (SparseConvTensor.dense(), channels last). The
    valid coordinates are unique, so each cell takes one write."""
    d, h, w = st.spatial_shape
    c = st.features.shape[1]
    cells = st.batch_size * d * h * w
    key = _linearize(st.coords, st.valid, st.spatial_shape)
    slot = torch.where(key == SENTINEL, cells, key)  # invalid rows: a spare row, dropped
    dense = st.features.new_zeros(cells + 1, c).index_add(
        0, slot, st.features * st.valid[:, None].to(st.features.dtype))
    return dense[:cells].reshape(st.batch_size, d, h, w, c)


@torch.no_grad()
def voxel_assignment(points: torch.Tensor, point_valid: torch.Tensor,
                     voxel_size: Tuple[float, float, float], pc_range: Tuple[float, ...],
                     spatial_shape: Tuple[int, int, int], max_voxels: int):
    """The discrete half of :func:`voxelize_points`: -> (keys [max_voxels],
    the sorted distinct voxel keys of the batch, SENTINEL past the last;
    slot [B*P], each point's row, ``max_voxels`` where it is dropped).

    As ``jnp.unique(keys, size=max_voxels, fill_value=SENTINEL)``, the cap
    keeps the ``max_voxels`` smallest keys of the whole batch, so a capped
    batch fills sample 0 first. Runs on the device without reading a value
    back."""
    b, p, _ = points.shape
    d, h, w = spatial_shape
    dev = points.device
    vx, vy, vz = voxel_size
    xi = torch.floor((points[..., 0] - pc_range[0]) / vx).long()
    yi = torch.floor((points[..., 1] - pc_range[1]) / vy).long()
    zi = torch.floor((points[..., 2] - pc_range[2]) / vz).long()
    inb = point_valid & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & (zi >= 0) & (zi < d)
    bi = torch.arange(b, device=dev)[:, None]
    keys = torch.where(inb, ((bi * d + zi) * h + yi) * w + xi, SENTINEL).reshape(-1)

    sk = torch.sort(keys).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sk[1:] != sk[:-1]])
    rank = torch.cumsum(first, 0) - 1
    place = torch.where(first & (rank < max_voxels), rank, max_voxels)
    uniq = torch.full((max_voxels + 1,), SENTINEL, dtype=torch.int64, device=dev)
    uniq = uniq.scatter(0, place, torch.where(place < max_voxels, sk, SENTINEL))[:max_voxels]

    slot = torch.searchsorted(uniq, keys).clamp(0, max_voxels - 1)
    hit = (uniq[slot] == keys) & (keys != SENTINEL)
    return uniq, torch.where(hit, slot, max_voxels)


def voxelize_points(points: torch.Tensor, point_valid: torch.Tensor,
                    voxel_size: Tuple[float, float, float],
                    pc_range: Tuple[float, ...], spatial_shape: Tuple[int, int, int],
                    max_voxels: int) -> SparseTensor:
    """Mean-VFE voxelisation into a fixed-capacity voxel list: the
    reference's VoxelGeneratorWrapper + MeanVFE as one op. points
    [B, P, F] with xyz first; point_valid [B, P]. The voxel set is
    :func:`voxel_assignment`'s."""
    b, p, f = points.shape
    d, h, w = spatial_shape
    uniq, slot = voxel_assignment(points, point_valid, voxel_size, pc_range, spatial_shape,
                                  max_voxels)
    hit = slot < max_voxels
    feats = points.reshape(b * p, f) * hit[:, None].to(points.dtype)
    summed = points.new_zeros(max_voxels + 1, f).index_add(0, slot, feats)[:max_voxels]
    counts = points.new_zeros(max_voxels + 1).index_add(0, slot, hit.to(points.dtype))
    counts = counts[:max_voxels]
    mean = summed / counts.clamp_min(1.0)[:, None]

    valid = uniq != SENTINEL
    kk = torch.where(valid, uniq, 0)
    coords = torch.stack([kk // (d * h * w), (kk // (h * w)) % d, (kk // w) % h, kk % w], -1)
    return SparseTensor(features=mean * valid[:, None].to(points.dtype), coords=coords,
                        valid=valid, spatial_shape=tuple(spatial_shape), batch_size=b)


def inverse_sparse_conv3d(st: SparseTensor, fine: SparseTensor, weight: torch.Tensor,
                          stride: Tuple[int, int, int],
                          padding: Tuple[int, int, int]) -> SparseTensor:
    """Inverse (transposed) sparse conv (spconv SparseInverseConv3d): back
    to a stored finer active set, the UNet decoder's op. out[f] = sum over
    kernel offsets k of W[k] @ in[c], where c * stride - pad + k == f and c
    is active in the coarse tensor ``st``."""
    kd, kh, kw, cin, _ = weight.shape
    dev = st.coords.device
    offs = torch.as_tensor(_offsets((kd, kh, kw)) + np.array([kd // 2, kh // 2, kw // 2]),
                           device=dev)
    strd = torch.as_tensor(stride, device=dev)
    padd = torch.as_tensor(padding, device=dev)
    sorted_keys, order = build_lookup(st)
    n, k = fine.capacity, offs.shape[0]
    num = fine.coords[:, None, 1:] + padd - offs[None]  # [N, K, 3]
    div_ok = (num % strd == 0).all(-1)
    cpos = torch.div(num, strd, rounding_mode="floor")
    qc = torch.cat([fine.coords[:, None, :1].expand(n, k, 1), cpos], -1).reshape(n * k, 4)
    qvalid = fine.valid.repeat_interleave(k) & div_ok.reshape(-1)
    src, found = lookup(sorted_keys, order, _linearize(qc, qvalid, st.spatial_shape))
    neigh = gather_rows(st.features, src, found).reshape(n, k, cin)
    out = _conv_matmul(neigh, weight) * fine.valid[:, None].to(st.features.dtype)
    return SparseTensor(features=out, coords=fine.coords, valid=fine.valid,
                        spatial_shape=fine.spatial_shape, batch_size=fine.batch_size)


def dense_conv3d_oracle(st: SparseTensor, weight: torch.Tensor, stride=(1, 1, 1),
                        padding=(1, 1, 1)) -> torch.Tensor:
    """A dense conv3d on the scattered grid -> [B, D', H', W', Cout]: the
    numerical oracle the sparse convs are tested against."""
    dense = to_dense(st).permute(0, 4, 1, 2, 3)
    out = F.conv3d(dense, weight.permute(4, 3, 0, 1, 2), stride=tuple(stride),
                   padding=tuple(padding))
    return out.permute(0, 2, 3, 4, 1)
