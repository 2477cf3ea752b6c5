"""A frozen copy of the JAX package's numpy commit oracle (`frieda_tpu/spec`),
kept beside the benchmark's tests so that the plain reference is held to it
without importing the JAX package. Do not edit: it is the yardstick."""
