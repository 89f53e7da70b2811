"""Tower families: weights from the seed, the program's tower, its plain
reference and its work a row, found by a configuration's ``family``."""
