"""Frozen copies of measuring code from elsewhere in the repository, each
headed by its source file and commit, so that the yardstick does not change
when those sources do."""
