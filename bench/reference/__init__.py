"""The benchmark's plain references: the pool's page layout and SECDED
codec, the seeded weights, and one decoder module per model family.

Nothing here imports the program under test: a reference only reads the
program's outputs to judge them.
"""
