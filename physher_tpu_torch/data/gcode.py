"""Genetic code tables (standard BEAST/physher ordering).

Codons are ordered lexicographically over A<C<G<T (AAA, AAC, ... TTT); each
genetic code is a 64-character amino-acid string with '*' marking stop codons
(reference: src/phyc/geneticcode.h:23-78, itself derived from BEAST's
GeneticCode.java — these are standard public tables).
"""

from __future__ import annotations

_NUC = "ACGT"

CODON_TRIPLETS = [a + b + c for a in _NUC for b in _NUC for c in _NUC]

GENETIC_CODES = [
    # 0 Universal
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    # 1 Vertebrate Mitochondrial
    "KNKNTTTT*S*SMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    # 2 Yeast
    "KNKNTTTTRSRSMIMIQHQHPPPPRRRRTTTTEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    # 3 Mold Protozoan Mitochondrial
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    # 4 Mycoplasma
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    # 5 Invertebrate Mitochondrial
    "KNKNTTTTSSSSMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    # 6 Ciliate
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVQYQYSSSS*CWCLFLF",
    # 7 Echinoderm Mitochondrial
    "NNKNTTTTSSSSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    # 8 Euplotid Nuclear
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSCCWCLFLF",
    # 9 Bacterial
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    # 10 Alternative Yeast
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLSLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF",
    # 11 Ascidian Mitochondrial
    "KNKNTTTTGSGSMIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSSWCWCLFLF",
    # 12 Flatworm Mitochondrial
    "NNKNTTTTSSSSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVYY*YSSSSWCWCLFLF",
    # 13 Blepharisma Nuclear
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*YQYSSSS*CWCLFLF",
    # 14 No stops
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVYYQYSSSSWCWCLFLF",
]

GENETIC_CODE_NAMES = [
    "Universal",
    "Vertebrate Mitochondrial",
    "Yeast",
    "Mold Protozoan Mitochondrial",
    "Mycoplasma",
    "Invertebrate Mitochondrial",
    "Ciliate",
    "Echinoderm Mitochondrial",
    "Euplotid Nuclear",
    "Bacterial",
    "Alternative Yeast",
    "Ascidian Mitochondrial",
    "Flatworm Mitochondrial",
    "Blepharisma Nuclear",
    "No stops",
]


def n_sense_codons(genetic_code: int) -> int:
    return sum(1 for aa in GENETIC_CODES[genetic_code] if aa != "*")


def sense_codon_indices(genetic_code: int) -> list[int]:
    """Indices (0..63) of non-stop codons for a genetic code."""
    return [i for i, aa in enumerate(GENETIC_CODES[genetic_code]) if aa != "*"]
