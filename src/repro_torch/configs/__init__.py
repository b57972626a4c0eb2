"""Published model configs (codeqwen1.5-7b so far)."""
