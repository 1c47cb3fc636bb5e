"""Runtime: model manager and the AIRuntime gRPC service."""
