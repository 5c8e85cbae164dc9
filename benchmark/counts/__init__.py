"""Operations and bytes of the program's work, counted from shapes and
ids: `scatter_add` for one call of kernel 1, and one module per
configuration's "reference" key for one training step of that model."""
