"""Reed-Solomon codec over GF(2^m), numpy (copy of ``repro.core.rs``)."""
