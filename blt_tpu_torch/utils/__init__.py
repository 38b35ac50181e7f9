"""Device helpers of the torch port."""
