"""Table-op layer: how the n-tuple weight-table lookups and updates
are expressed to XLA.

The reference's CPU hot loops (table gathers and scatter-adds in the
TD(0) step) become batched gathers/scatters (``dispatch``), with the
two-level one-hot matmul form (``onehot``) kept as an alternative
formulation of the same lookups, and the digit-permutation planner
(``digit_perm``) for the D4 symmetry fold.
"""

from .onehot import (
    CLASS_DECOMP,
    TableClasses,
    build_table_classes,
    onehot_eval,
    onehot_update,
)

__all__ = [
    "CLASS_DECOMP",
    "TableClasses",
    "build_table_classes",
    "onehot_eval",
    "onehot_update",
]
