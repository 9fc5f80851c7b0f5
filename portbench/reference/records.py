"""Mapping record types of the two output formats the check compares,
paired-end BED and 4DN pairs.

Mirrors the reference's bit-packed PODs (bed_mapping.h, pairs_mapping.h):
sort order (operator<), duplicate equality (operator== / IsSamePosition),
and Tn5 shift semantics per type.

mapq is stored saturated to 6 bits (mapq_:6 bitfield in the reference), so
writers and comparators see the same truncated values.
"""

from __future__ import annotations

from dataclasses import dataclass

U16 = 0xFFFF


def clip_mapq(mapq: int) -> int:
    return mapq & 0x3F


@dataclass
class PEBedRecord:
    """Paired-end BED/BEDPE record (PairedEndMappingWith(out)Barcode)."""

    read_id: int
    barcode: int
    start: int
    length: int  # fragment length, uint16
    mapq: int
    direction: int
    is_unique: int
    num_dups: int
    positive_alignment_length: int
    negative_alignment_length: int
    has_barcode: bool = False

    def sort_key(self):
        if self.has_barcode:
            return (self.start, self.length, self.barcode, self.mapq,
                    self.direction, self.is_unique, self.read_id,
                    self.positive_alignment_length, self.negative_alignment_length)
        return (self.start, self.length, self.mapq, self.direction,
                self.is_unique, self.read_id, self.positive_alignment_length,
                self.negative_alignment_length)

    def dup_key(self):
        if self.has_barcode:
            return (self.barcode, self.start, self.length)
        return (self.start, self.length)

    def same_position_key(self):
        return (self.start, self.length)

    def tn5_shift(self) -> None:
        self.start += 4
        self.positive_alignment_length = (self.positive_alignment_length - 4) & U16
        self.length = (self.length - 9) & U16
        self.negative_alignment_length = (self.negative_alignment_length - 5) & U16

    def start_position(self) -> int:
        return self.start

    def end_position(self) -> int:
        return self.start + self.length


@dataclass
class PairsRecord:
    """4DN pairs record (pairs_mapping.h)."""

    read_id: int
    read_name: bytes
    barcode: int
    rid1: int
    rid2: int
    pos1: int
    pos2: int
    strand1: int  # 1 positive
    strand2: int
    mapq: int
    is_unique: int
    num_dups: int

    def sort_key(self):
        # pairs_mapping.h:40-43
        return (self.rid1, self.rid2, self.pos1, self.pos2, self.mapq,
                self.read_id)

    def dup_key(self):
        # pairs_mapping.h:44-49
        return (self.rid1, self.pos1, self.rid2, self.pos2)

    def same_position_key(self):
        return (self.rid1, self.pos1, self.rid2, self.pos2)

    def tn5_shift(self) -> None:
        pass

    def start_position(self) -> int:
        return self.pos1

    def end_position(self) -> int:
        return self.pos1 + 1
