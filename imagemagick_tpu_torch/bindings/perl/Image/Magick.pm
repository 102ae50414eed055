package Image::Magick;

# PerlMagick compatibility module for imagemagick_tpu_torch, the PyTorch
# port.  A copy of the JAX package's bindings/perl/Image/Magick.pm that
# spawns the port's server.
#
# A pure-Perl (core modules only: JSON::PP + IPC::Open2) stand-in for the
# reference's XS binding (PerlMagick's Magick.xs).  Each Image::Magick
# object owns a MagickWand inside a persistent Python worker
# (imagemagick_tpu_torch.wand.rpc_server), so all pixel work runs there,
# on the CUDA card unless the script asks for the CPU; this module only
# marshals method calls over a pipe.
#
# The device is $Image::Magick::Device, 'cuda' unless the script sets it
# before its first new:
#   use Image::Magick;
#   $Image::Magick::Device = 'cpu';
# Without a card the default 'cuda' server exits at start, and new dies.
# IMTPU_PYTHON names the Python interpreter that runs the server
# (python3 by default).
#
# Supported surface mirrors Magick.pm POD conventions:
#   my $image = Image::Magick->new;
#   my $x = $image->Read('rose:');      warn $x if $x;   # "" on success
#   $image->Resize(geometry => '50%');
#   $image->Blur(sigma => 2.0);
#   my ($w, $h) = $image->Get('width', 'height');
#   $image->Set(quality => 90);
#   $x = $image->Write('out.png');
#
# Methods dispatch through wand/perl_compat.py's PerlMagick-name table;
# errors come back as "Exception NNN: message" strings per PerlMagick's
# return convention (never dies).

use strict;
use warnings;
use JSON::PP ();
use IPC::Open2 qw(open2);
use File::Basename qw(dirname);
use Cwd qw(abs_path);
use Scalar::Util qw(blessed);

our $VERSION = '7.1.1';
our $Device = 'cuda';

my ($CHLD_IN, $CHLD_OUT, $PID);
my $JSON = JSON::PP->new->canonical->allow_nonref;
my $NEXT_ID = 0;

sub _start_server {
    return if $PID;
    my $python = $ENV{IMTPU_PYTHON} || 'python3';
    # this file is <root>/imagemagick_tpu_torch/bindings/perl/Image/Magick.pm
    my $root = abs_path(dirname(__FILE__) . '/../../../..');
    local $ENV{PYTHONPATH} = defined $ENV{PYTHONPATH}
        ? "$root:$ENV{PYTHONPATH}" : $root;
    $PID = open2($CHLD_OUT, $CHLD_IN, $python, '-m',
                 'imagemagick_tpu_torch.wand.rpc_server',
                 '--device', $Device);
    die "Image::Magick: cannot start rpc server" unless $PID;
}

sub _rpc {
    my ($req) = @_;
    _start_server();
    $req->{id} = ++$NEXT_ID;
    print {$CHLD_IN} $JSON->encode($req), "\n";
    $CHLD_IN->flush;
    my $line = readline($CHLD_OUT);
    die "Image::Magick: rpc server closed the pipe" unless defined $line;
    return $JSON->decode($line);
}

sub new {
    my $class = shift;
    my $r = _rpc({op => 'new'});
    my $self = bless {handle => $r->{result}{wand}}, $class;
    $self->Set(@_) if @_;
    return $self;
}

sub DESTROY {
    my $self = shift;
    return unless $PID && defined $self->{handle};
    eval { _rpc({op => 'destroy', wand => $self->{handle}}) };
}

sub Clone {
    my $self = shift;
    my $r = _rpc({op => 'clone', wand => $self->{handle}});
    return bless {handle => $r->{result}{wand}}, ref $self;
}
sub Copy { goto &Clone }

sub Get {
    my $self = shift;
    my $r = _rpc({op => 'get', wand => $self->{handle}, attrs => [@_]});
    return "Exception 410: $r->{error}" if $r->{error};
    my @vals = @{$r->{result}};
    return wantarray ? @vals : $vals[0];
}
sub GetAttribute { goto &Get }

sub Set {
    my $self = shift;
    my %attrs = @_ == 1 ? (filename => $_[0]) : @_;
    my $r = _rpc({op => 'set', wand => $self->{handle}, attrs => \%attrs});
    return $r->{error} ? "Exception 410: $r->{error}" : "";
}
sub SetAttribute { goto &Set }

# Montage/Fx/Append/... return fresh wands; everything routes through the
# perl_compat dispatch, which reports unknown names as errors.
our $AUTOLOAD;

sub AUTOLOAD {
    my $self = shift;
    (my $name = $AUTOLOAD) =~ s/.*:://;
    return if $name eq 'DESTROY';
    my %kw = @_ == 1 ? (filename => $_[0]) : @_;
    # marshal Image::Magick arguments (e.g. Composite(image => $other))
    for my $k (keys %kw) {
        my $v = $kw{$k};
        $kw{$k} = $v->{handle}
            if blessed($v) && $v->isa('Image::Magick');
    }
    my $r = _rpc({op => 'pm', wand => $self->{handle}, method => $name,
                  kwargs => \%kw});
    return "Exception 410: $r->{error}" if $r->{error};
    my $res = $r->{result};
    if (ref $res eq 'HASH' && defined $res->{wand}) {
        return bless {handle => $res->{wand}}, ref $self;
    }
    # mutating methods return "" (success) per PerlMagick convention
    return defined $res ? $res : "";
}

# Class-level helpers (Magick.pm exports)
sub QueryColor {
    my ($class, @names) = @_;
    my $probe = Image::Magick->new;
    my @out;
    for my $name (@names) {
        my $px = _rpc({op => 'pm', wand => $probe->{handle},
                       method => 'QueryColorHelper',
                       kwargs => {color => $name}});
        push @out, $px->{error} ? undef : $px->{result};
    }
    return wantarray ? @out : $out[0];
}

1;

__END__

=head1 NAME

Image::Magick - PerlMagick compatibility layer over imagemagick_tpu_torch
(PyTorch on a CUDA card, or on the CPU with $Image::Magick::Device = 'cpu').

=head1 LIMITATIONS

Objects are scalar image lists (no per-frame array dereference); XS-only
entry points (BlobToImage with coder hints, Mogrify) route through the
named methods instead.

=cut
