# The CIM-MLC compiler: abstraction, graph, mapping, the CG/MVM/VVM
# scheduling passes, meta-operator code generation and the driver.
