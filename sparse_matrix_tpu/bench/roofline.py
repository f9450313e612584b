"""Roofline accounting for sparse kernels: published device peaks keyed
by ``jax.Device.device_kind``.

Peaks are NVIDIA's data-sheet dense rates (no structured sparsity) at the
card's full power limit; a card set below it cannot hold them under load,
so a roofline share is reported beside the card's power limit. A device
kind missing from the table is an error, not a default.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["DeviceSpec", "PEAKS", "device_spec", "spmv_ideal_bytes",
           "spgemm_flops", "roofline_pct"]


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_gbps: float
    bf16_tflops: float
    f32_tflops: float
    source: str


_NVIDIA_H100 = "NVIDIA H100 Tensor Core GPU data sheet (dense rates)"

PEAKS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(
        name="H100 SXM", hbm_gbps=3350.0, bf16_tflops=989.0,
        f32_tflops=67.0, source=_NVIDIA_H100),
}


def device_spec(kind: str) -> DeviceSpec:
    """Peaks of the device kind ``kind``; raises KeyError when unknown."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add it to "
            "sparse_matrix_tpu.bench.roofline.PEAKS with its source"
        ) from None


def spmv_ideal_bytes(nnz: int, rows: int, cols: int, *, val_bytes: int = 4, idx_bytes: int = 4) -> int:
    """Ideal CSR working set: vals + column indices once, x and y once."""
    return nnz * (val_bytes + idx_bytes) + (rows + cols) * val_bytes


def spgemm_flops(intermediate_products: int) -> int:
    """2 flops (mul + add) per intermediate product."""
    return 2 * intermediate_products


def roofline_pct(achieved_gbps: float, spec: DeviceSpec) -> float:
    """Achieved bytes/s as a percentage of the device's memory peak."""
    return 100.0 * achieved_gbps / spec.hbm_gbps
