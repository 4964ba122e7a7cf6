"""The plain references, one file per configuration, and their shared
Fock-space construction. They import neither jax nor either solver
package."""
