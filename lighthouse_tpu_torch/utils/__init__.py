from .hash import sha256, hash32_concat, ZERO_HASHES
