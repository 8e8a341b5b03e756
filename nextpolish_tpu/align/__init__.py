"""Built-in read mapper: minimizer seeding + chaining + banded extension.

Replaces the reference's vendored bwa mem / minimap2 subprocesses
(SURVEY.md §1 L1) with a device-first design: host-side minimizer index and
seed voting, batched banded affine-gap alignment on device, CIGAR traceback
vectorized across the batch.
"""
