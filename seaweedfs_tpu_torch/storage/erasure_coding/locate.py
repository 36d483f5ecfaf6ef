"""Needle -> shard interval math for the two-level EC block layout.

Layout (ref: weed/storage/erasure_coding/ec_locate.go): the .dat is striped
row-major over 10 data shards in 1GB "large" blocks while >=1 full large row
remains, then in 1MB "small" blocks. A needle spanning block boundaries maps
to multiple intervals; each interval resolves to (shard id, offset inside the
shard file) where the shard file holds its large blocks first, then its small
blocks (ec_locate.go:73-83).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import DATA_SHARDS_COUNT


@dataclass(frozen=True)
class Interval:
    block_index: int
    inner_block_offset: int
    size: int
    is_large_block: bool
    large_block_rows_count: int
    data_shards: int = DATA_SHARDS_COUNT  # row width (k of the RS geometry)

    def to_shard_id_and_offset(
        self, large_block_size: int, small_block_size: int
    ) -> tuple[int, int]:
        """Ref ec_locate.go:73-83."""
        ec_file_offset = self.inner_block_offset
        row_index = self.block_index // self.data_shards
        if self.is_large_block:
            ec_file_offset += row_index * large_block_size
        else:
            ec_file_offset += (
                self.large_block_rows_count * large_block_size
                + row_index * small_block_size
            )
        shard_id = self.block_index % self.data_shards
        return shard_id, ec_file_offset


def _locate_offset_within_blocks(block_length: int, offset: int) -> tuple[int, int]:
    return offset // block_length, offset % block_length


def _locate_offset(
    large_block_length: int,
    small_block_length: int,
    dat_size: int,
    offset: int,
    data_shards: int = DATA_SHARDS_COUNT,
) -> tuple[int, bool, int]:
    large_row_size = large_block_length * data_shards
    n_large_block_rows = dat_size // large_row_size
    if offset < n_large_block_rows * large_row_size:
        block_index, inner = _locate_offset_within_blocks(large_block_length, offset)
        return block_index, True, inner
    offset -= n_large_block_rows * large_row_size
    block_index, inner = _locate_offset_within_blocks(small_block_length, offset)
    return block_index, False, inner


def locate_data(
    large_block_length: int,
    small_block_length: int,
    dat_size: int,
    offset: int,
    size: int,
    data_shards: int = DATA_SHARDS_COUNT,
) -> list[Interval]:
    """Ref LocateData (ec_locate.go:11-48); data_shards parametrizes the
    row width for alternate RS geometries (6.3 / 12.4).

    Faithful to a latent reference BUG: three row-count derivations
    disagree in a narrow window. The encoder's large-row loop uses
    strictly-greater (ec_encoder.go:214), _locate_offset's layout
    boundary uses dat_size//(L*k) (ec_locate.go:52), and the
    large->small transition plus ToShardIdAndOffset use the
    shard-derived +k*S addend count (ec_locate.go:15,73-83). For
    dat_size in [n*L*k - k*S, n*L*k] — ~10MB per 10GB at real
    geometry — the reference's own reader mis-addresses shards ITS OWN
    encoder wrote. Reproduced identically here for wire parity;
    tests/test_property.py pins both the consistent domain and the
    broken window (test_ec_row_boundary_window_is_reference_faithful)."""
    block_index, is_large_block, inner_block_offset = _locate_offset(
        large_block_length, small_block_length, dat_size, offset, data_shards
    )
    # adding DataShardsCount*smallBlockLength ensures the large-row count can
    # be derived from a shard size (ec_locate.go:14-15)
    n_large_block_rows = (dat_size + data_shards * small_block_length) // (
        large_block_length * data_shards
    )

    intervals: list[Interval] = []
    while size > 0:
        block_remaining = (
            large_block_length - inner_block_offset
            if is_large_block
            else small_block_length - inner_block_offset
        )
        if size <= block_remaining:
            intervals.append(
                Interval(
                    block_index=block_index,
                    inner_block_offset=inner_block_offset,
                    size=size,
                    is_large_block=is_large_block,
                    large_block_rows_count=n_large_block_rows,
                    data_shards=data_shards,
                )
            )
            return intervals
        intervals.append(
            Interval(
                block_index=block_index,
                inner_block_offset=inner_block_offset,
                size=block_remaining,
                is_large_block=is_large_block,
                large_block_rows_count=n_large_block_rows,
                data_shards=data_shards,
            )
        )
        size -= block_remaining
        block_index += 1
        if is_large_block and block_index == n_large_block_rows * data_shards:
            is_large_block = False
            block_index = 0
        inner_block_offset = 0
    return intervals
