"""Light client: header verification with sequential or skipping
(bisection) modes, providers, the trusted store and attack detection.
Every commit check runs on B1 through types/validation."""
