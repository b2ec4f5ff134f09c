"""MCU / block grid arithmetic shared by encoder and decoder.

The 4:2:0 encoder geometry mirrors reference src/encoder/jpezy_encoder.hpp:55-56
(ceil(H/16) x ceil(W/16) MCUs); the general decoder geometry mirrors
src/decoder/jpezy_decoder.hpp:94-99 (ceil-block counts and hmax/vmax MCU grid).
"""
from __future__ import annotations

import dataclasses

BLOCK = 8
MCU_420 = 16  # MCU edge for 2x2 luma sampling


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class EncodeGeometry:
    """Grid geometry for the fixed 4:2:0 encoder."""

    width: int
    height: int

    @property
    def mcus_x(self) -> int:
        return cdiv(self.width, MCU_420)

    @property
    def mcus_y(self) -> int:
        return cdiv(self.height, MCU_420)

    @property
    def num_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def padded_width(self) -> int:
        return self.mcus_x * MCU_420

    @property
    def padded_height(self) -> int:
        return self.mcus_y * MCU_420

    @property
    def num_y_blocks(self) -> int:
        return self.num_mcus * 4

    @property
    def num_c_blocks(self) -> int:
        return self.num_mcus

    @property
    def num_blocks(self) -> int:
        """Total entropy-coded blocks (Y0 Y1 Y2 Y3 Cb Cr per MCU)."""
        return self.num_mcus * 6


@dataclasses.dataclass(frozen=True)
class ComponentGeometry:
    """Per-component geometry for the general decoder."""

    h_samp: int  # H sampling factor of this component
    v_samp: int
    hmax: int
    vmax: int
    width: int   # image width
    height: int

    @property
    def mcus_x(self) -> int:
        return cdiv(cdiv(self.width, BLOCK), self.hmax)

    @property
    def mcus_y(self) -> int:
        return cdiv(cdiv(self.height, BLOCK), self.vmax)

    @property
    def blocks_per_mcu(self) -> int:
        return self.h_samp * self.v_samp

    @property
    def plane_width(self) -> int:
        """Padded component-resolution plane width in samples."""
        return self.mcus_x * self.h_samp * BLOCK

    @property
    def plane_height(self) -> int:
        return self.mcus_y * self.v_samp * BLOCK

    @property
    def dup_x(self) -> int:
        """Nearest-neighbor upsample factor (reference jpezy_decoder.hpp:510)."""
        return self.hmax // self.h_samp

    @property
    def dup_y(self) -> int:
        return self.vmax // self.v_samp
