"""What a cell's window drives: one module a kind of unit (an
`Entry` class), named by the workload file's "entry"."""
