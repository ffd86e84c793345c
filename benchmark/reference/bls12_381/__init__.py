"""BLS12-381 in pure Python for the benchmark's reference verdicts.

A frozen copy of the port's host field tower, curve groups, hash-to-G2 and
pairing (``fields``, ``curve``, ``hash_to_curve``, ``pairing``). It imports
nothing of the program, so a fault there cannot make the reference agree
with it.
"""
