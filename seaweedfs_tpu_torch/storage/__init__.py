"""Storage formats the erasure-coding slice reads and writes: needles,
super block, .idx/.ecx index, .vif volume info, and the EC pipeline."""
