"""TPC-H on the port: the eight tables (data.py), the 22 query texts
(queries.py) and a numpy oracle for each of them (oracle.py). Nothing here
imports jax, pandas or pyarrow."""
