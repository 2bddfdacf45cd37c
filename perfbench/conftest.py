# drivers/test_passes.py is a traffic driver, not a test module
collect_ignore = ['drivers']
