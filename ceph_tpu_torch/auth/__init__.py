"""Authentication (reference: src/auth — cephx; SURVEY.md §2.7)."""
from .cephx import (
    AuthError,
    CephxAuthenticator,
    derive_s3_secret,
    derive_service_key,
    frame_tag,
    generate_secret,
    mint_ticket,
    proof_hex,
    seal,
    session_key_from_nonces,
    unseal,
    validate_ticket,
)

__all__ = [
    "AuthError",
    "CephxAuthenticator",
    "derive_s3_secret",
    "derive_service_key",
    "frame_tag",
    "generate_secret",
    "mint_ticket",
    "proof_hex",
    "seal",
    "session_key_from_nonces",
    "unseal",
    "validate_ticket",
]
