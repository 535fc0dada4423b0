"""The distributed backend: executor processes over TCP (worker.py), the
driver's service and fleet (driver_service.py, backend.py), the shuffle
servers and the wire (shuffle_server.py, protocol.py). Context(mode=
"distributed") starts it."""
