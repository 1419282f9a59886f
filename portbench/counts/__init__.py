"""Operations and bytes a kernel call needs, computed from its shapes: one
module a kernel, each with `ops(**shape)` and `nbytes(**shape)`.  Each
input byte is counted read once and each output byte written once; where
the work depends on the data, the count is what these inputs need."""
