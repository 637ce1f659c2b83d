"""Date-ranged input directories.

Reference: photon-client .../util/DateRange.scala:107 ("yyyyMMdd-yyyyMMdd"),
DaysRange.scala:80 ("start-end" days before today, start >= end >= 0), and
IOUtils.getInputPathsWithinDateRange (photon-client .../util/IOUtils.scala:113-154):
input data lives in daily directories ``<base>/yyyy/MM/dd``; a range selects
the existing day directories, optionally erroring on missing days.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import os
from typing import List, Optional, Sequence

DATE_PATTERN = "%Y%m%d"
DELIMITER = "-"


@dataclasses.dataclass(frozen=True)
class DateRange:
    start: _dt.date
    end: _dt.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"Invalid range: start date {self.start} comes after end date {self.end}."
            )

    def days(self) -> List[_dt.date]:
        n = (self.end - self.start).days
        return [self.start + _dt.timedelta(days=i) for i in range(n + 1)]

    def __str__(self) -> str:
        return (
            f"{self.start.strftime(DATE_PATTERN)}{DELIMITER}"
            f"{self.end.strftime(DATE_PATTERN)}"
        )

    @staticmethod
    def from_string(range_str: str) -> "DateRange":
        """Parse 'yyyyMMdd-yyyyMMdd' (DateRange.fromDateString)."""
        parts = range_str.split(DELIMITER)
        if len(parts) != 2:
            raise ValueError(
                f"Couldn't parse the range {range_str!r} using delimiter {DELIMITER!r}."
            )
        try:
            start = _dt.datetime.strptime(parts[0], DATE_PATTERN).date()
            end = _dt.datetime.strptime(parts[1], DATE_PATTERN).date()
        except ValueError as e:
            raise ValueError(f"Couldn't parse the date range: {range_str}") from e
        return DateRange(start, end)


@dataclasses.dataclass(frozen=True)
class DaysRange:
    """Days before today: start >= end >= 0 (DaysRange.scala)."""

    start_days: int
    end_days: int

    def __post_init__(self):
        if self.start_days < 0 or self.end_days < 0:
            raise ValueError("Invalid range: days ago must be >= 0")
        if self.start_days < self.end_days:
            raise ValueError(
                f"Invalid range: start of range {self.start_days} is fewer days "
                f"ago than end of range {self.end_days}."
            )

    def to_date_range(self, today: Optional[_dt.date] = None) -> DateRange:
        today = today or _dt.date.today()
        return DateRange(
            today - _dt.timedelta(days=self.start_days),
            today - _dt.timedelta(days=self.end_days),
        )

    def __str__(self) -> str:
        return f"{self.start_days}{DELIMITER}{self.end_days}"

    @staticmethod
    def from_string(range_str: str) -> "DaysRange":
        parts = range_str.split(DELIMITER)
        if len(parts) != 2:
            raise ValueError(
                f"Couldn't parse the range {range_str!r} using delimiter {DELIMITER!r}."
            )
        return DaysRange(int(parts[0]), int(parts[1]))


def input_paths_within_date_range(
    base_dirs: Sequence[str] | str,
    date_range: DateRange,
    error_on_missing: bool = False,
) -> List[str]:
    """Existing '<base>/yyyy/MM/dd' day directories within the range
    (IOUtils.getInputPathsWithinDateRange semantics: filter missing days
    unless error_on_missing; error when nothing matches)."""
    if isinstance(base_dirs, str):
        base_dirs = [base_dirs]
    out: List[str] = []
    for base in base_dirs:
        paths = [
            os.path.join(base, day.strftime("%Y/%m/%d"))
            for day in date_range.days()
        ]
        if error_on_missing:
            for p in paths:
                if not os.path.exists(p):
                    raise FileNotFoundError(f"Path {p} does not exist")
        out.extend(p for p in paths if os.path.exists(p))
    if not out:
        raise FileNotFoundError(
            f"No data folder found between {date_range.start} and "
            f"{date_range.end} in {list(base_dirs)}"
        )
    return out
