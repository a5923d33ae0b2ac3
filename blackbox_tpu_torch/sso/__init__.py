"""Solar-system object cross-matching (match2SSO equivalent)."""
