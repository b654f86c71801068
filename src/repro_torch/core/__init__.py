# The system core of the port: grammar, modulations, the segmented store,
# the backends over the Hopper kernels, the VectorCache and the SQL
# materializer.
