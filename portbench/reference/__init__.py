"""Plain references of what the benchmark's cells verify.

Each module here follows the upstream semantics from the inputs alone
and imports nothing of the program under test, of ``jax`` or of the JAX
package.  A configuration names its reference by module (its
``reference`` key).
"""
