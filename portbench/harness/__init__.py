"""The general part of the benchmark: everything that is not one
configuration, one traffic mix, one metric or one reference."""
