"""The plain reference the correctness check holds the port against.

Plain PyTorch and NumPy; imports nothing of the port, of the JAX
package or jax."""
