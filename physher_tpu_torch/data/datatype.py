"""Data types: nucleotide, amino-acid, codon, and generic user-defined alphabets.

Re-expresses the reference's DataType vtable (reference: src/phyc/datatype.c,
src/phyc/datatype.h:70-87) as plain Python classes producing NumPy encoding
tables. Encodings above ``state_count`` denote ambiguity codes; each encoding
maps to a 0/1 "partial" row over the concrete states (the tip partial used by
the pruning engine). Fully-unknown codes map to all-ones rows.
"""

from __future__ import annotations

import numpy as np

from .gcode import GENETIC_CODES, CODON_TRIPLETS

# Nucleotide alphabet in *encoding order* (matches the reference's ambiguity
# table order, reference: src/phyc/datatype.h:25-68 NUCLEOTIDE_AMBIGUITY_STATES).
_NUC_CODES = "ACGTURYMWSKBDHVN?-"
_NUC_PARTIALS = np.array(
    [
        [1, 0, 0, 0],  # A
        [0, 1, 0, 0],  # C
        [0, 0, 1, 0],  # G
        [0, 0, 0, 1],  # T
        [0, 0, 0, 1],  # U
        [1, 0, 1, 0],  # R
        [0, 1, 0, 1],  # Y
        [1, 1, 0, 0],  # M
        [1, 0, 0, 1],  # W
        [0, 1, 1, 0],  # S
        [0, 0, 1, 1],  # K
        [0, 1, 1, 1],  # B
        [1, 0, 1, 1],  # D
        [1, 1, 0, 1],  # H
        [1, 1, 1, 0],  # V
        [1, 1, 1, 1],  # N
        [1, 1, 1, 1],  # ?
        [1, 1, 1, 1],  # -
    ],
    dtype=np.float64,
)

_AA_CODES = "ACDEFGHIKLMNPQRSTVWYBZX*?-"


def _aa_partials() -> np.ndarray:
    out = np.zeros((26, 20))
    for i in range(20):
        out[i, i] = 1.0
    # B = N or D ; Z = Q or E (IUPAC ambiguity)
    out[20, _AA_CODES.index("N")] = 1.0
    out[20, _AA_CODES.index("D")] = 1.0
    out[21, _AA_CODES.index("Q")] = 1.0
    out[21, _AA_CODES.index("E")] = 1.0
    out[22:26, :] = 1.0  # X * ? -
    return out


class DataType:
    """Base class: maps symbols to integer encodings and encodings to partials.

    ``state_count`` concrete states; encodings in ``[0, n_codes)`` where codes
    ``>= state_count`` are ambiguities. ``partials_table`` has one row per code.
    """

    name: str
    state_count: int
    symbol_length: int = 1

    def encode(self, symbol: str) -> int:
        raise NotImplementedError

    def symbol(self, encoding: int) -> str:
        raise NotImplementedError

    @property
    def n_codes(self) -> int:
        return self.partials_table.shape[0]

    def code_table(self) -> np.ndarray | None:
        """256-entry char->code table for single-char datatypes (drives the
        vectorized encoder in encode_sequence);
        None for multi-char symbols (codons)."""
        if self.symbol_length != 1:
            return None
        try:
            unknown = self.encode("?")
        except (KeyError, ValueError, IndexError):
            unknown = self.n_codes - 1
        table = np.full(256, unknown, dtype=np.uint8)
        for b in range(33, 127):
            try:
                table[b] = self.encode(chr(b))
            except (KeyError, ValueError, IndexError):
                pass
        return table

    def encode_sequence(self, seq: str) -> np.ndarray:
        L = len(seq)
        k = self.symbol_length
        if L % k:
            raise ValueError(
                f"sequence length {L} not a multiple of symbol length {k}"
            )
        if k == 1:
            table = self.code_table()
            if table is not None:
                raw = np.frombuffer(seq.encode(), dtype=np.uint8)
                return table[raw].astype(np.int32)
        return np.array(
            [self.encode(seq[i : i + k]) for i in range(0, L, k)], dtype=np.int32
        )

    def __eq__(self, other):
        return isinstance(other, DataType) and self.name == other.name

    def __hash__(self):
        return hash(self.name)


class NucleotideDataType(DataType):
    name = "nucleotide"
    state_count = 4

    def __init__(self):
        table = np.full(128, _NUC_CODES.index("?"), dtype=np.int32)
        for i, c in enumerate(_NUC_CODES):
            table[ord(c)] = i
            table[ord(c.lower())] = i
        table[ord("u")] = table[ord("U")] = 3  # U == T
        self._ascii = table
        self.partials_table = _NUC_PARTIALS.copy()

    def encode(self, symbol: str) -> int:
        return int(self._ascii[ord(symbol[0]) & 0x7F])

    def symbol(self, encoding: int) -> str:
        return _NUC_CODES[encoding]


class AminoAcidDataType(DataType):
    name = "aa"
    state_count = 20

    def __init__(self):
        table = np.full(128, _AA_CODES.index("?"), dtype=np.int32)
        for i, c in enumerate(_AA_CODES):
            table[ord(c)] = i
            if c.isalpha():
                table[ord(c.lower())] = i
        self._ascii = table
        self.partials_table = _aa_partials()

    def encode(self, symbol: str) -> int:
        return int(self._ascii[ord(symbol[0]) & 0x7F])

    def symbol(self, encoding: int) -> str:
        return _AA_CODES[encoding]


class CodonDataType(DataType):
    """Codon alphabet over sense codons of a genetic code (60/61 states).

    Symbols are nucleotide triplets; any triplet containing ambiguity, or a
    stop codon, encodes to the fully-unknown code (reference:
    src/phyc/datatype.c codon encoding).
    """

    symbol_length = 3

    def __init__(self, genetic_code: int = 0):
        self.genetic_code = genetic_code
        code = GENETIC_CODES[genetic_code]
        self.name = f"codon{genetic_code}"
        nuc = NucleotideDataType()
        sense = [i for i, aa in enumerate(code) if aa != "*"]
        self.state_count = len(sense)
        self._triplet_to_state = {}
        self.triplets = []
        for s, i in enumerate(sense):
            t = CODON_TRIPLETS[i]
            self._triplet_to_state[t] = s
            self.triplets.append(t)
        n = self.state_count
        self.partials_table = np.vstack([np.eye(n), np.ones((1, n))])
        self._nuc = nuc

    def encode(self, symbol: str) -> int:
        t = symbol.upper().replace("U", "T")
        return self._triplet_to_state.get(t, self.state_count)

    def symbol(self, encoding: int) -> str:
        if encoding < self.state_count:
            return self.triplets[encoding]
        return "???"


class GeneralDataType(DataType):
    """User-defined alphabet with explicit ambiguity mapping.

    Mirrors the reference's generic datatype used through the C++ wrapper
    (reference: src/phyc/datatype.c new_GenericDataType,
    src/phycpp/physher.hpp GeneralDataTypeInterface).
    """

    def __init__(self, states: list[str], ambiguities: dict[str, list[str]] | None = None):
        self.name = "general(" + ",".join(states) + ")"
        self.states = list(states)
        self.state_count = len(states)
        self.symbol_length = max(len(s) for s in states)
        if any(len(s) != self.symbol_length for s in states):
            raise ValueError("all state symbols must have equal length")
        self._index = {s: i for i, s in enumerate(states)}
        rows = [np.eye(self.state_count)[i] for i in range(self.state_count)]
        self._codes = list(states)
        ambiguities = ambiguities or {}
        for sym, members in ambiguities.items():
            row = np.zeros(self.state_count)
            for m in members:
                row[self._index[m]] = 1.0
            self._index[sym] = len(rows)
            self._codes.append(sym)
            rows.append(row)
        # unknown catch-all
        self._unknown = len(rows)
        self._codes.append("?")
        rows.append(np.ones(self.state_count))
        self.partials_table = np.vstack(rows)

    def encode(self, symbol: str) -> int:
        return self._index.get(symbol, self._unknown)

    def symbol(self, encoding: int) -> str:
        return self._codes[encoding]


_SINGLETONS: dict[str, DataType] = {}


def get_datatype(name, genetic_code: int = 0) -> DataType:
    """Factory by name: 'nucleotide', 'aa'/'amino acid'/'protein', 'codon'."""
    if isinstance(name, DataType):
        return name
    key = str(name).lower()
    if key in ("nucleotide", "dna", "rna"):
        key = "nucleotide"
        maker = NucleotideDataType
    elif key in ("aa", "amino acid", "aminoacid", "protein"):
        key = "aa"
        maker = AminoAcidDataType
    elif key == "codon":
        key = f"codon{genetic_code}"
        maker = lambda: CodonDataType(genetic_code)  # noqa: E731
    else:
        raise ValueError(f"unknown datatype {name!r}")
    if key not in _SINGLETONS:
        _SINGLETONS[key] = maker()
    return _SINGLETONS[key]
