"""String table utilities: fingerprint keying, clustering, dedup.

Parity: reference core/util —
- `FingerPrintKeyer` (FingerPrintKeyer.java:33-120): OpenRefine-style
  fingerprint — trim, lowercase, strip punctuation/control chars, split
  on whitespace, sort + uniquify fragments, rejoin, asciify.
- `StringCluster` (StringCluster.java:36-94): fingerprint → {variant:
  count} clusters, `getClusters` sorted largest-first.
- `StringGrid` (StringGrid.java:50-748): a row-major table of strings
  with CSV-ish IO and column surgery (select/filter/sort/split/merge/
  fill-down/dedupe-by-cluster/similarity filtering). The reference's
  `dedupeByCluster` (:291) stops at printing candidate clusters; here
  dedup actually rewrites each variant to its cluster's most frequent
  form.

These are host-side data-cleaning helpers feeding the NLP pipeline —
pure Python by design (no device work); the port's copy of the JAX
package's `utils/string_grid.py`.
"""

from __future__ import annotations

import re
import unicodedata
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.utils.math_utils import string_similarity

__all__ = ["FingerPrintKeyer", "StringCluster", "StringGrid", "NONE"]

NONE = "NONE"  # reference StringGrid.NONE :57

_PUNCT_CTRL = re.compile(r"[^\w\s]|[\x00-\x08\x0a-\x1f\x7f]|_")


class FingerPrintKeyer:
    """reference FingerPrintKeyer.java:38-58."""

    def key(self, s: str) -> str:
        if s is None:
            raise ValueError("Fingerprint keyer accepts a single string")
        s = s.strip().lower()
        s = _PUNCT_CTRL.sub("", s)
        frags = sorted(set(s.split()))
        return self._asciify(" ".join(frags))

    @staticmethod
    def _asciify(s: str) -> str:
        """Strip diacritics to ASCII equivalents (reference asciify :60)."""
        decomposed = unicodedata.normalize("NFKD", s)
        return "".join(c for c in decomposed
                       if not unicodedata.combining(c))


class StringCluster:
    """Cluster strings by fingerprint (reference StringCluster.java:36):
    'Two words', 'TWO words' and 'words two' share one cluster. Maps
    fingerprint → {original string: count}."""

    def __init__(self, strings: Iterable[str]):
        keyer = FingerPrintKeyer()
        self.clusters: Dict[str, Dict[str, int]] = defaultdict(dict)
        for s in strings:
            m = self.clusters[keyer.key(s)]
            m[s] = m.get(s, 0) + 1

    def __getitem__(self, fingerprint: str) -> Dict[str, int]:
        return self.clusters.get(fingerprint, {})

    def __len__(self) -> int:
        return len(self.clusters)

    def get_clusters(self) -> List[Dict[str, int]]:
        """Clusters sorted largest-first (reference getClusters :74 with
        SizeComparator)."""
        return sorted(self.clusters.values(), key=len, reverse=True)

    def canonical(self, s: str) -> str:
        """Most frequent variant in s's cluster (ties: lexicographically
        first, matching the reference's TreeMap ordering)."""
        m = self[FingerPrintKeyer().key(s)]
        if not m:
            return s
        return min(m.items(), key=lambda kv: (-kv[1], kv[0]))[0]


class StringGrid:
    """Row-major string table (reference StringGrid.java:50)."""

    def __init__(self, sep: str, data: Optional[Iterable[str]] = None,
                 num_columns: Optional[int] = None):
        self.sep = sep
        self.rows: List[List[str]] = []
        if data is not None:
            for line in data:
                line = line.rstrip("\n")
                if not line:
                    continue
                self.append_line(line)
            if self.rows:
                num_columns = len(self.rows[0])
        self.num_columns = num_columns or 0

    # ------------------------------------------------------------------ io
    @classmethod
    def from_file(cls, path: str, sep: str) -> "StringGrid":
        """reference fromFile :90."""
        with open(path, encoding="utf-8") as f:
            return cls(sep, f)

    def append_line(self, line: str) -> None:
        row = line.split(self.sep)
        if self.rows and len(row) != len(self.rows[0]):
            raise ValueError(
                f"row has {len(row)} columns, expected {len(self.rows[0])}")
        self.rows.append(row)

    def to_lines(self) -> List[str]:
        """reference toLines :445."""
        return [self.sep.join(r) for r in self.rows]

    def write_lines_to(self, path: str) -> None:
        """reference writeLinesTo :498."""
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.to_lines()) + "\n")

    # ------------------------------------------------------------- shape
    def __len__(self) -> int:
        return len(self.rows)

    def get_row(self, i: int) -> List[str]:
        return self.rows[i]

    def get_column(self, column: int) -> List[str]:
        """reference getColumn :670."""
        return [r[column] for r in self.rows]

    def head(self, num: int) -> "StringGrid":
        """First `num` rows (reference head :166 printed; returning is
        more useful)."""
        g = StringGrid(self.sep, num_columns=self.num_columns)
        g.rows = [list(r) for r in self.rows[:num]]
        return g

    def add_row(self, row: Sequence[str]) -> None:
        self.rows.append(list(row))

    def add_column(self, column: Sequence[str]) -> None:
        """reference addColumn :591."""
        if len(column) != len(self.rows):
            raise ValueError("column length != row count")
        for r, v in zip(self.rows, column):
            r.append(v)
        self.num_columns += 1

    # ------------------------------------------------------- row surgery
    def remove_rows_with_empty_column(self, column: int,
                                      missing_value: str = "") -> None:
        """reference removeRowsWithEmptyColumn :156/:202."""
        self.rows = [r for r in self.rows if r[column] != missing_value]

    def remove_columns(self, *columns: int) -> None:
        """reference removeColumns :181."""
        drop = set(columns)
        self.rows = [[v for i, v in enumerate(r) if i not in drop]
                     for r in self.rows]
        self.num_columns -= len(drop)

    def filter_rows_by_column(self, column: int,
                              values: Iterable[str]) -> None:
        """Keep only rows whose column value is in `values` (reference
        filterRowsByColumn :423)."""
        keep = set(values)
        self.rows = [r for r in self.rows if r[column] in keep]

    def select(self, column: int, value: str) -> "StringGrid":
        """reference select :510."""
        g = StringGrid(self.sep, num_columns=self.num_columns)
        g.rows = [list(r) for r in self.rows if r[column] == value]
        return g

    def sort_by(self, column: int) -> None:
        """reference sortBy :434."""
        self.rows.sort(key=lambda r: r[column])

    def fill_down(self, value: str, column: int) -> None:
        """reference fillDown :503."""
        for r in self.rows:
            r[column] = value

    def swap(self, column1: int, column2: int) -> None:
        """reference swap :460."""
        for r in self.rows:
            r[column1], r[column2] = r[column2], r[column1]

    def merge(self, column1: int, column2: int) -> None:
        """Join two columns into column1 and drop column2
        (reference merge :469)."""
        for r in self.rows:
            r[column1] = r[column1] + r[column2]
        self.remove_columns(column2)

    def split(self, column: int, sep_by: str) -> None:
        """Split a column in place into multiple columns
        (reference split :522)."""
        widths = {len(r[column].split(sep_by)) for r in self.rows}
        if len(widths) != 1:
            raise ValueError("column splits into varying widths")
        for r in self.rows:
            parts = r[column].split(sep_by)
            r[column:column + 1] = parts
        self.num_columns += widths.pop() - 1

    def prepend_to_each(self, prefix: str, column: int) -> None:
        """reference prependToEach :578."""
        for r in self.rows:
            r[column] = prefix + r[column]

    def append_to_each(self, suffix: str, column: int) -> None:
        """reference appendToEach :585."""
        for r in self.rows:
            r[column] = r[column] + suffix

    # ----------------------------------------------------------- queries
    def map_by_primary_key(self, column: int) -> Dict[str, List[List[str]]]:
        """reference mapByPrimaryKey :650."""
        out: Dict[str, List[List[str]]] = defaultdict(list)
        for r in self.rows:
            out[r[column]].append(r)
        return dict(out)

    def get_rows_with_duplicate_values_in_column(self, column: int
                                                 ) -> "StringGrid":
        """reference getRowsWithDuplicateValuesInColumn :689."""
        counts: Dict[str, int] = defaultdict(int)
        for r in self.rows:
            counts[r[column]] += 1
        g = StringGrid(self.sep, num_columns=self.num_columns)
        g.rows = [list(r) for r in self.rows if counts[r[column]] > 1]
        return g

    def get_all_with_similarity(self, threshold: float, first_column: int,
                                second_column: int) -> "StringGrid":
        """Rows whose two columns are at least `threshold` similar by
        shared-bigram similarity (reference getAllWithSimilarity :485 →
        MathUtils.stringSimilarity)."""
        g = StringGrid(self.sep, num_columns=self.num_columns)
        g.rows = [list(r) for r in self.rows
                  if string_similarity(r[first_column],
                                       r[second_column]) >= threshold]
        return g

    def filter_by_similarity(self, threshold: float, first_column: int,
                             second_column: int) -> None:
        """Drop rows below the similarity threshold (reference
        filterBySimilarity :566)."""
        self.rows = [r for r in self.rows
                     if string_similarity(r[first_column],
                                          r[second_column]) >= threshold]

    # ---------------------------------------------------------- clustering
    def cluster_column(self, column: int) -> StringCluster:
        """reference clusterColumn :277."""
        return StringCluster(self.get_column(column))

    def dedupe_by_cluster(self, column: int) -> None:
        """Rewrite each value to its fingerprint cluster's most frequent
        variant (reference dedupeByCluster :291 — which identified the
        clusters but never applied the rewrite; completed here)."""
        cluster = self.cluster_column(column)
        for r in self.rows:
            r[column] = cluster.canonical(r[column])

    def dedupe_by_cluster_all(self) -> None:
        """reference dedupeByClusterAll :282."""
        for c in range(self.num_columns):
            self.dedupe_by_cluster(c)
